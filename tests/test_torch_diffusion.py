"""Port diffusion grid: the reference's own checks (mass conservation,
decay, sources, sampling, gradient) and parity with the jitted reference
at a voxel of 1.5, where dividing by the voxel and multiplying by its
float32 reciprocal floor differently. The card-only test at the end holds
the secretion kernel to the CPU's slot-order sum, bit for bit; it needs no
JAX (the GPU host runs it with
``python -m pytest -q tests/test_torch_diffusion.py -m cuda``)."""

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
