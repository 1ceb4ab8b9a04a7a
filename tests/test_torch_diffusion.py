"""Port diffusion grid: the reference's own checks (mass conservation,
decay, sources, sampling, gradient) and parity with the jitted reference
at a voxel of 1.5, where dividing by the voxel and multiplying by its
float32 reciprocal floor differently. The card-only test at the end holds
the secretion kernel to the CPU's slot-order sum, bit for bit; it needs no
JAX (the GPU host runs it with
``python -m pytest -q tests/test_torch_diffusion.py -m cuda``)."""

import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import diffusion as TD  # noqa: E402

ORIGIN = np.array([0.3, -1.0, 0.5], np.float32)
DIMS = (9, 7, 8)


@pytest.fixture(autouse=True)
def _single_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def ref():
    """The JAX reference (imported here, so the card-only test runs where
    JAX is not installed): (jax, jax.numpy, repro.core.diffusion)."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.core import diffusion
    return jax, jnp, diffusion


def _kw(**kw):
    return {"dims": DIMS, "coefficient": 0.3, "decay": 0.02, "voxel": 1.5,
            **kw}


def _specs(ref=None, **kw):
    """(the reference's spec or None without ``ref``, the port's spec)."""
    return (None if ref is None else ref[2].DiffusionSpec(**_kw(**kw)),
            TD.DiffusionSpec(**_kw(**kw)))


def test_mass_conservation_neumann():
    _, spec = _specs(dims=(12, 12, 12), coefficient=0.2, decay=0.0,
                     voxel=1.0)
    c = torch.zeros(spec.dims)
    c[6, 6, 6] = 100.0
    dt = TD.stable_dt(spec)
    for _ in range(50):
        c = TD.step(spec, c, dt)
    np.testing.assert_allclose(float(c.sum()), 100.0, rtol=1e-5)
    assert float(c.max()) < 100.0
    assert float(c.min()) >= -1e-9


def test_decay():
    _, spec = _specs(dims=(8, 8, 8), coefficient=0.0, decay=0.1, voxel=1.0)
    c = TD.step(spec, torch.full(spec.dims, 1.0), 1.0)
    np.testing.assert_allclose(c.numpy(), 0.9, rtol=1e-6)


def test_sources_and_sample():
    _, spec = _specs(dims=(8, 8, 8), voxel=1.0)
    pos = torch.tensor([[3.5, 3.5, 3.5], [3.6, 3.4, 3.5]])
    c = TD.add_sources(spec, torch.zeros(spec.dims), pos,
                       torch.tensor([2.0, 3.0]), torch.zeros(3))
    assert float(c[3, 3, 3]) == 5.0 and float(c.sum()) == 5.0
    np.testing.assert_allclose(TD.sample(spec, c, pos, torch.zeros(3)
                                         ).numpy(), [5.0, 5.0])


def test_gradient_points_uphill():
    _, spec = _specs(dims=(16, 8, 8), voxel=1.0)
    c = torch.arange(16, dtype=torch.float32)[:, None, None].expand(
        spec.dims).contiguous()
    g = TD.gradient(spec, c, torch.tensor([[8.0, 4.0, 4.0]]), torch.zeros(3))
    np.testing.assert_allclose(g[0].numpy(), [1.0, 0.0, 0.0], atol=1e-6)


def _edge_positions():
    """Positions one to four ulps below origin + k·voxel along each axis:
    there floor(p / 1.5) and floor(p · float32(1/1.5)) part ways."""
    rows = []
    for axis in range(3):
        for k in range(DIMS[axis] + 1):
            x = np.float32(ORIGIN[axis] + k * 1.5)
            for _ in range(4):
                x = np.nextafter(x, np.float32(-100))
                p = ORIGIN + 1.0
                p[axis] = x
                rows.append(p.copy())
    return np.asarray(rows, np.float32)


def test_voxel_of_matches_jitted_reference(ref):
    jax, jnp, JD = ref
    jspec, tspec = _specs(ref)
    rng = np.random.default_rng(0)
    pos = np.concatenate([_edge_positions(),
                          rng.uniform(-2, 15, (4000, 3)).astype(np.float32)])
    want = np.asarray(jax.jit(lambda p: JD.voxel_of(
        jspec, p, jnp.asarray(ORIGIN)))(pos))
    got = TD.voxel_of(tspec, torch.from_numpy(pos), torch.from_numpy(ORIGIN))
    np.testing.assert_array_equal(got.numpy(), want)
    eager = np.asarray(JD.voxel_of(jspec, jnp.asarray(pos),
                                   jnp.asarray(ORIGIN)))
    assert (eager != want).any(), "the edge positions must tell them apart"


def test_step_gradient_sources_match_jitted_reference(ref):
    jax, jnp, JD = ref
    jspec, tspec = _specs(ref)
    rng = np.random.default_rng(1)
    c = rng.uniform(0, 5, DIMS).astype(np.float32)
    pos = np.concatenate([_edge_positions(),
                          rng.uniform(-1, 14, (3000, 3)).astype(np.float32)])
    amount = rng.uniform(0, 1, len(pos)).astype(np.float32)
    og = jnp.asarray(ORIGIN)
    tc, tp, to = (torch.from_numpy(x) for x in (c, pos, ORIGIN))
    want = np.asarray(jax.jit(lambda c: JD.step(jspec, c, 0.4))(c))
    got = TD.step(tspec, tc, 0.4).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * want.max())
    want = np.asarray(jax.jit(lambda c, p: JD.gradient(jspec, c, p, og))(
        c, pos))
    np.testing.assert_array_equal(TD.gradient(tspec, tc, tp, to).numpy(),
                                  want)
    want = np.asarray(jax.jit(lambda c, p, a: JD.add_sources(
        jspec, c, p, a, og))(c, pos, amount))
    np.testing.assert_array_equal(
        TD.add_sources(tspec, tc, tp, torch.from_numpy(amount), to).numpy(),
        want)
    want = np.asarray(jax.jit(lambda c, p: JD.sample(jspec, c, p, og))(
        c, pos))
    np.testing.assert_array_equal(TD.sample(tspec, tc, tp, to).numpy(), want)


def test_step_slab_with_external_halos_matches_reference(ref):
    jax, jnp, JD = ref
    jspec, tspec = _specs(ref)
    rng = np.random.default_rng(2)
    c, lo, hi = (rng.uniform(0, 3, s).astype(np.float32)
                 for s in (DIMS, DIMS[1:], DIMS[1:]))
    want = np.asarray(jax.jit(lambda c, lo, hi: JD.step_slab(
        jspec, c, 0.25, lo, hi))(c, lo, hi))
    got = TD.step_slab(tspec, torch.from_numpy(c), 0.25,
                       torch.from_numpy(lo), torch.from_numpy(hi))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * want.max())
    assert TD.stable_dt(tspec) == JD.stable_dt(jspec)


def test_diffusion_ops_route_to_the_functions():
    _, spec = _specs()
    ops = TD.DiffusionOps(spec, torch.from_numpy(ORIGIN))
    c = torch.rand(DIMS, generator=torch.Generator().manual_seed(0))
    p = torch.tensor([[1.0, 2.0, 3.0], [5.0, 1.0, 4.0]])
    assert torch.equal(ops.step(c, 0.1), TD.step(spec, c, 0.1))
    assert torch.equal(ops.sample(c, p), TD.sample(spec, c, p, ops.origin))
    assert torch.equal(ops.gradient(c, p),
                       TD.gradient(spec, c, p, ops.origin))
    assert torch.equal(ops.add_sources(c, p, torch.ones(2)),
                       TD.add_sources(spec, c, p, torch.ones(2), ops.origin))


def test_add_sources_plain_is_slot_order():
    """The plain version (the CPU's index_add) adds a voxel's amounts in
    slot order: the card's kernel is held to exactly this."""
    _, spec = _specs(dims=(4, 4, 4), voxel=1.0)
    amount = torch.tensor([1.0, 2.0 ** -24, 2.0 ** -24, -1.0])
    pos = torch.full((4, 3), 0.5)
    c = TD.add_sources(spec, torch.zeros(spec.dims), pos, amount,
                       torch.zeros(3))
    want = np.float32(0)
    for a in amount.numpy():
        want = np.float32(want + a)
    assert float(c[0, 0, 0]) == float(want) == 0.0   # not 2^-23


def _secretion_case(n=65_536, voxels=8, seed=0):
    """Many agents per voxel (65,536 into 8 voxels) with amounts spread
    over ten binades: a sum whose value depends on its order."""
    rng = np.random.default_rng(seed)
    spec = TD.DiffusionSpec(dims=(2, 2, 2), voxel=1.0)
    assert voxels == 8
    pos = rng.uniform(0.0, 2.0, (n, 3)).astype(np.float32)
    amount = (rng.uniform(1.0, 2.0, n) * 2.0 ** rng.integers(-5, 5, n)
              * rng.choice([-1.0, 1.0], n)).astype(np.float32)
    conc = rng.uniform(0.0, 1.0, spec.dims).astype(np.float32)
    return spec, conc, pos, amount


@pytest.mark.cuda
def test_add_sources_on_the_card_is_reproducible_and_slot_order():
    """Secretion on the card: two runs on the same inputs give equal bits,
    and equal the plain CPU version's slot-order sum bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    spec, conc, pos, amount = _secretion_case()
    origin = torch.zeros(3)
    want = TD.add_sources(spec, torch.from_numpy(conc),
                          torch.from_numpy(pos), torch.from_numpy(amount),
                          origin)
    dev = torch.device("cuda")
    args = (torch.from_numpy(conc).to(dev), torch.from_numpy(pos).to(dev),
            torch.from_numpy(amount).to(dev), origin.to(dev))
    runs = [TD.add_sources(spec, *args[:3], args[3]).cpu()
            for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(runs[0], runs[1]), "two card runs differ"
    assert torch.equal(runs[0], want), \
        f"card differs from the CPU's slot order by " \
        f"{float((runs[0] - want).abs().max())}"


def _boundary_positions(spec_dims, voxel, origin, rng, n_random=600):
    """Positions on voxel faces (exact multiples of the voxel from the
    origin), up to three ulps either side of them, below the origin and
    past the grid's top on each axis, and random ones in and around the
    grid."""
    rows = []
    for axis in range(3):
        for k in range(-2, spec_dims[axis] + 3):
            face = np.float32(origin[axis] + k * voxel)
            xs = [face]
            lo = hi = face
            for _ in range(3):
                lo = np.nextafter(lo, np.float32(-1e9))
                hi = np.nextafter(hi, np.float32(1e9))
                xs += [lo, hi]
            for x in xs:
                p = origin + np.float32(0.5 * voxel)
                p[axis] = x
                rows.append(p.copy())
    for axis in range(3):                      # far below and far above
        for x in (-1e6, -40.0, -voxel, 1e6, 40.0 + spec_dims[axis] * voxel):
            p = origin + np.float32(0.5 * voxel)
            p[axis] = np.float32(origin[axis] + x)
            rows.append(p.copy())
    top = origin + np.asarray(spec_dims, np.float32) * np.float32(voxel)
    rows += list(rng.uniform(origin - 3.0, top + 3.0, (n_random, 3)))
    return np.asarray(rows, np.float32)


def test_add_sources_plain_matches_reference_at_faces_and_outside(ref):
    """The plain add_sources (the function the card kernel is held to) ≡
    the jitted reference's scatter, bit for bit, for rows on voxel faces,
    a few ulps either side, below the origin and past the top (clamped
    into the edge voxels), in slot order with amounts over ten binades."""
    jax, jnp, JD = ref
    rng = np.random.default_rng(7)
    for voxel, dims in ((1.5, DIMS), (1.0, (4, 4, 4)), (2.0, (3, 1, 5))):
        jspec, tspec = _specs(ref, dims=dims, voxel=voxel)
        pos = _boundary_positions(dims, voxel, ORIGIN, rng)
        amount = (rng.uniform(1.0, 2.0, len(pos))
                  * 2.0 ** rng.integers(-5, 5, len(pos))
                  * rng.choice([-1.0, 1.0], len(pos))).astype(np.float32)
        c = rng.uniform(0, 1, dims).astype(np.float32)
        want = np.asarray(jax.jit(lambda c, p, a: JD.add_sources(
            jspec, c, p, a, jnp.asarray(ORIGIN)))(c, pos, amount))
        got = TD.add_sources(tspec, torch.from_numpy(c), torch.from_numpy(pos),
                             torch.from_numpy(amount),
                             torch.from_numpy(ORIGIN))
        np.testing.assert_array_equal(got.numpy(), want,
                                      err_msg=f"voxel {voxel}, dims {dims}")


def test_add_sources_plain_over_lanes_equals_each_lanes_solo_call(ref):
    """Over an ensemble's lanes the plain add_sources gives each lane's
    grid exactly its solo call's, and each solo call is the reference's."""
    from repro_torch.core.lanes import Lanes
    jax, jnp, JD = ref
    jspec, tspec = _specs(ref)
    rng = np.random.default_rng(8)
    n_lanes = 5
    pos = np.concatenate([_boundary_positions(DIMS, 1.5, ORIGIN, rng, 400)
                          for _ in range(n_lanes)])
    n = len(pos) // n_lanes
    amount = rng.uniform(-1, 1, n_lanes * n).astype(np.float32)
    conc = rng.uniform(0, 1, (n_lanes, *DIMS)).astype(np.float32)
    got = TD.add_sources(tspec, torch.from_numpy(conc),
                         torch.from_numpy(pos), torch.from_numpy(amount),
                         torch.from_numpy(ORIGIN), Lanes(n_lanes, n))
    for lane in range(n_lanes):
        rows = slice(lane * n, (lane + 1) * n)
        solo = TD.add_sources(tspec, torch.from_numpy(conc[lane]),
                              torch.from_numpy(pos[rows]),
                              torch.from_numpy(amount[rows]),
                              torch.from_numpy(ORIGIN))
        assert torch.equal(got[lane], solo), lane
        want = np.asarray(jax.jit(lambda c, p, a: JD.add_sources(
            jspec, c, p, a, jnp.asarray(ORIGIN)))(conc[lane], pos[rows],
                                                  amount[rows]))
        np.testing.assert_array_equal(solo.numpy(), want, err_msg=str(lane))


@pytest.mark.parametrize("bad", ["cpu", "position", "amount", "origin",
                                 "lanes", "grid", "dtype"])
def test_secretion_wrapper_raises_on_cpu_tensors_and_bad_shapes(bad):
    """kernels/secretion.add takes CUDA tensors of the kernel's shapes
    only: CPU tensors, and each shape it does not take, raise ValueError
    before anything is built or launched."""
    from repro_torch.kernels import secretion
    n, dims = 12, (2, 3, 4)
    conc = torch.zeros(dims)
    pos, amount, origin = torch.zeros((n, 3)), torch.ones(n), torch.zeros(3)
    lane_rows = n
    if bad == "position":
        pos = torch.zeros((n, 2))
    elif bad == "amount":
        amount = torch.ones(n + 1)
    elif bad == "origin":
        origin = torch.zeros(2)
    elif bad == "lanes":
        lane_rows = 5
    elif bad == "grid":
        conc = torch.zeros((3, *dims))
    elif bad == "dtype":
        conc = torch.zeros(dims, dtype=torch.float64)
    before = secretion.add.launches
    with pytest.raises(ValueError):
        secretion.add(conc, pos, amount, origin, dims, 1.0, lane_rows)
    assert secretion.add.launches == before


def _card_secretion_case(name):
    """(spec, conc, position, amount, lanes) of one card case, on the CPU;
    the names say which path of csrc/secretion.cu each one takes."""
    from repro_torch.core.lanes import Lanes
    rng = np.random.default_rng(zlib.crc32(name.encode()))

    def rows(n, dims, voxel=1.0):
        pos = rng.uniform(-0.5, dims[0] * voxel + 0.5, (n, 3)).astype(
            np.float32)
        amount = (rng.uniform(1.0, 2.0, n) * 2.0 ** rng.integers(-5, 5, n)
                  * rng.choice([-1.0, 1.0], n)).astype(np.float32)
        return pos, amount
    lanes, n_lanes = None, 1
    if name == "one-voxel":                    # radix path, no digit pass
        dims, n = (1, 1, 1), 65_536
    elif name == "8-voxels":                   # one 3-bit pass, a warp a voxel
        dims, n = (2, 2, 2), 65_536
    elif name == "32^3":                       # two 8-bit passes
        dims, n = (32, 32, 32), 65_536
    elif name == "32^3-skewed":                # a run past the warp's lanes
        dims, n = (32, 32, 32), 65_536
    elif name == "ragged":                     # rows not a multiple of a tile
        dims, n = (32, 32, 32), 10_001
    elif name == "8-lanes":                    # the local path, lanes
        dims, n, n_lanes = (32, 32, 32), 4000, 8
    elif name == "16-lanes":
        dims, n, n_lanes = (8, 8, 8), 1000, 16
    elif name == "2-lanes-radix":              # the radix path over lanes
        dims, n, n_lanes = (16, 16, 16), 10_000, 2
    elif name == "local-skewed":               # every row in one voxel
        dims, n = (32, 32, 32), 4000
    elif name == "empty":
        dims, n = (4, 5, 6), 0
    spec = TD.DiffusionSpec(dims=dims, voxel=1.0)
    parts = [rows(n, dims) for _ in range(n_lanes)]
    pos = np.concatenate([p for p, _ in parts]).reshape(-1, 3)
    amount = np.concatenate([a for _, a in parts])
    if name == "32^3-skewed":
        pos[::2] = np.float32(7.25)
    if name == "local-skewed":
        pos[:] = np.float32(3.5)
    conc = rng.uniform(0, 1, (n_lanes, *dims) if n_lanes > 1 else dims
                       ).astype(np.float32)
    conc.reshape(-1)[::7] = np.float32(-0.0)
    if n_lanes > 1:
        lanes = Lanes(n_lanes, n)
    return spec, conc, pos, amount, lanes


def _takes_the_radix_path(conc, pos, lanes):
    """Whether csrc/secretion.cu sorts these rows by its radix path (its
    plan(), from the source's constants) rather than in one launch."""
    from repro_torch.kernels import build
    k = build.constants("secretion")
    lane_rows = lanes.capacity if lanes else len(pos)
    blocks = -(-conc.size // k["kLocal"])
    return len(pos) > 0 and (lane_rows > k["kLocalRows"]
                             or blocks * lane_rows > k["kLocalVisits"])


SECRETION_CARD_CASES = ["one-voxel", "8-voxels", "32^3", "32^3-skewed",
                        "ragged", "8-lanes", "16-lanes", "2-lanes-radix",
                        "local-skewed", "empty"]


def test_secretion_card_cases_are_what_they_say():
    """The card cases below reach every path of the kernel: the radix
    path (over a tile of rows a lane) at 1, 8 and 32³ voxels, a voxel
    with half the rows, a ragged last tile, over 2 lanes; the local path
    over 8 and 16 lanes and with every row in one voxel; no rows."""
    from repro_torch.kernels import build
    tile = build.constants("secretion")["kTile"]
    for name in SECRETION_CARD_CASES:
        spec, conc, pos, amount, lanes = _card_secretion_case(name)
        n = len(pos)
        radix = _takes_the_radix_path(conc, pos, lanes)
        assert radix == (name in ("one-voxel", "8-voxels", "32^3",
                                  "32^3-skewed", "ragged",
                                  "2-lanes-radix")), name
        assert conc.size == (lanes.n if lanes else 1) * np.prod(spec.dims)
        v = TD._flat(spec, TD.voxel_of(spec, torch.from_numpy(pos),
                                       torch.zeros(3)), lanes)
        top = int(torch.bincount(v).max()) if n else 0
        if name in ("32^3-skewed",):
            assert top > 256 and n / conc.size < 256
        if name == "local-skewed":
            assert top == n
        if name == "ragged":
            assert n % tile != 0 and n > tile
        if name == "empty":
            assert n == 0


@pytest.mark.cuda
@pytest.mark.parametrize("name", SECRETION_CARD_CASES)
def test_secretion_cuda_kernel_matches_the_cpu_on_every_path(name):
    """csrc/secretion.cu ≡ the plain CPU add_sources (index_add in slot
    order), bit for bit, on each case above; two card runs are bit-equal;
    one launch a call, and no clone, sort or id arithmetic beside it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels import secretion
    spec, conc, pos, amount, lanes = _card_secretion_case(name)
    args = [torch.from_numpy(x) for x in (conc, pos, amount)]
    origin = torch.zeros(3)
    want = TD.add_sources(spec, *args, origin, lanes)
    dev = torch.device("cuda")
    gargs = [x.to(dev) for x in args]
    before = secretion.add.launches
    runs = [TD.add_sources(spec, *gargs, origin.to(dev), lanes).cpu()
            for _ in range(2)]
    torch.cuda.synchronize()
    assert secretion.add.launches == before + 2
    assert torch.equal(runs[0], runs[1]), "two card runs differ"
    assert torch.equal(runs[0], want), \
        f"{name}: card differs from the CPU's slot order by " \
        f"{float((runs[0] - want).abs().max())}"
    assert (torch.signbit(runs[0]) == torch.signbit(want)).all()
    # the C side's scratch size picks the path: none on the local one
    lane_rows = lanes.capacity if lanes else len(pos)
    assert (secretion._kernel_fns()[1](len(pos), lane_rows, conc.size) > 0) \
        == _takes_the_radix_path(conc, pos, lanes), name
