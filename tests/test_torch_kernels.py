"""K1 in the port ≡ the reference's K1 (Pallas, interpret mode) and oracle.

Column maps and overflow flags must match exactly, nnz exactly, forces to
atol 1e-4 (the tolerance tests/test_kernels.py holds Pallas K1 to). On the
CPU the port's wrapper runs K1's plain version; the CUDA kernel itself is
held against that plain version by the card-only tests at the end, which
need no JAX (the GPU host runs them with
``python -m pytest -q tests/test_torch_kernels.py -m cuda``).
"""

import dataclasses
import types
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import forces as tforces, grid as tgrid  # noqa: E402
from repro_torch.core import morton as tmorton  # noqa: E402
from repro_torch.kernels import collision_force as tk1  # noqa: E402
from repro_torch.kernels import ops as tops, ref as tref  # noqa: E402

ADH = ((0.5, 0.1), (0.1, 0.7))


@pytest.fixture
def ref():
    """The JAX reference modules (imported here, so the card-only tests run
    where JAX is not installed)."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.core import forces
    from repro.kernels import ops, ref as oracle
    return types.SimpleNamespace(jax=jax, jnp=jnp, forces=forces, ops=ops,
                                 oracle=oracle)


@pytest.fixture(autouse=True)
def _single_thread():
    """torch's multi-threaded CPU kernels were seen to return a whole
    worker's chunk of float32 sqrt results off by ~3e-4 (relative) on some
    hosts; one thread keeps the parity tests deterministic."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _sorted_case(seed, n, c, dims, box, active_frac=1.0):
    """Grid-ordered pool (as the engine's resident build leaves it)."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, dims[0] * box * 0.99, (n, 3)).astype(np.float32)
    dia = rng.uniform(0.4, box - 0.45, (n,)).astype(np.float32)
    typ = rng.integers(0, 2, (n,)).astype(np.int32)
    P = np.zeros((c, 3), np.float32)
    P[:n] = pos
    D = np.zeros((c,), np.float32)
    D[:n] = dia
    T = np.zeros((c,), np.int32)
    T[:n] = typ
    A = np.zeros((c,), bool)
    A[:n] = True
    act = A.copy()
    if active_frac < 1.0:
        act[:n] = rng.random(n) < active_frac
    keys = tmorton.grid_sort_keys(torch.from_numpy(P), torch.from_numpy(A),
                                  torch.zeros(3), box, dims)
    order = torch.sort(keys, stable=True).indices
    starts, counts = tgrid.box_tables(keys[order], tmorton.linear_size(dims))
    order = order.numpy()
    return (P[order], D[order], T[order], A[order], act[order],
            starts.numpy(), counts.numpy())


def _t(x):
    return torch.from_numpy(np.array(x))


def _both(ref, case, dims, box, adhesion, maxb=64):
    jax, jnp, jops = ref.jax, ref.jnp, ref.ops
    P, D, T, A, act, starts, counts = case
    origin = jnp.zeros(3, jnp.float32)
    box_c = jnp.asarray(box, jnp.float32)
    # jitted with origin/box as constants, as the reference engine runs it
    jfn = jax.jit(lambda *a: jops.collision_force_resident(
        *a, origin, box_c, dims=dims, k_rep=2.0, adhesion=adhesion,
        adhesion_band=0.4, maxb=maxb))
    jf, jn, jo = jfn(P, D, T, A, act, starts, counts)
    tf, tn, to = tops.collision_force_resident(
        _t(P), _t(D), _t(T), _t(A), _t(act), _t(starts), _t(counts),
        torch.zeros(3), box, dims=dims, k_rep=2.0, adhesion=adhesion,
        adhesion_band=0.4, maxb=maxb)
    return (np.asarray(jf), np.asarray(jn), bool(jo)), \
        (tf.numpy(), tn.numpy(), bool(to))


K1_CASES = [
    (60, 128, (8, 8, 8), 2.0, None, 1.0),
    (200, 256, (10, 10, 10), 2.0, ADH, 1.0),
    (500, 512, (12, 12, 12), 1.5, ADH, 1.0),
    (300, 300, (10, 10, 10), 2.0, ADH, 0.5),   # C % 128 != 0, static subset
    (250, 333, (9, 9, 9), 2.2, None, 0.3),     # C % 128 != 0, static subset
]


@pytest.mark.parametrize("n,c,dims,box,adhesion,active_frac", K1_CASES)
def test_k1_matches_pallas_and_oracle(ref, n, c, dims, box, adhesion,
                                      active_frac):
    jnp = ref.jnp
    case = _sorted_case(n + c, n, c, dims, box, active_frac)
    (jf, jn, jo), (tf, tn, to) = _both(ref, case, dims, box, adhesion)
    assert tf.dtype == np.float32 and tn.dtype == np.int32
    assert to == jo is False
    np.testing.assert_allclose(tf, jf, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(tn, jn)
    P, D, T, A, act = case[:5]
    fr, nr = ref.oracle.collision_force_ref(
        jnp.asarray(P), jnp.asarray(D), jnp.asarray(T), jnp.asarray(A), 2.0,
        adhesion, 0.4)
    np.testing.assert_allclose(tf, np.where(act[:, None], fr, 0.0), rtol=0,
                               atol=1e-4)
    np.testing.assert_array_equal(tn, np.where(act, nr, 0))


@pytest.mark.parametrize("n,c,dims,box,adhesion,active_frac", K1_CASES)
def test_build_block_cols_exact(ref, n, c, dims, box, adhesion,
                                active_frac):
    jnp = ref.jnp
    P, D, T, A, act, starts, counts = _sorted_case(n + c, n, c, dims, box,
                                                   active_frac)
    n_pad = -(-c // 128) * 128
    Pp = np.zeros((n_pad, 3), np.float32)
    Pp[:c] = P
    ap = np.zeros(n_pad, bool)
    ap[:c] = act & A
    cells = tmorton.cell_of(_t(Pp), torch.zeros(3), box, dims)
    for maxb, span in ((64, 8), (2, 8), (64, 1)):   # tight: may overflow
        jc, jo = ref.ops.build_block_cols(jnp.asarray(cells.numpy()),
                                       jnp.asarray(starts),
                                       jnp.asarray(counts), jnp.asarray(ap),
                                       dims, maxb, span)
        tc, to = tops.build_block_cols(cells, _t(starts), _t(counts),
                                       _t(ap), dims, maxb, span)
        assert tc.dtype == torch.int32
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        assert bool(to) == bool(jo)


def test_k1_overflow_flag_matches(ref):
    """A row block whose runs need more than maxb column blocks."""
    case = _sorted_case(3, 500, 512, (3, 3, 3), 4.0)
    (jf, jn, jo), (tf, tn, to) = _both(ref, case, (3, 3, 3), 4.0, None,
                                       maxb=2)
    assert jo and to


@pytest.mark.parametrize("adhesion", [None, ADH])
def test_collision_force_ref_matches(ref, rng, adhesion):
    jnp = ref.jnp
    n = 150
    pos = rng.uniform(0, 10, (n, 3)).astype(np.float32)
    dia = rng.uniform(0.5, 2.0, n).astype(np.float32)
    typ = rng.integers(0, 2, n).astype(np.int32)
    alive = rng.random(n) < 0.9
    jf, jn = ref.oracle.collision_force_ref(
        jnp.asarray(pos), jnp.asarray(dia), jnp.asarray(typ),
        jnp.asarray(alive), 2.0, adhesion, 0.4)
    tf, tn = tref.collision_force_ref(_t(pos), _t(dia), _t(typ), _t(alive),
                                      2.0, adhesion, 0.4)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=0, atol=1e-4)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))


def test_pair_force_and_displacement_match(ref, rng):
    jnp, jforces = ref.jnp, ref.forces
    b, m = 40, 12
    q_pos = rng.uniform(0, 4, (b, 3)).astype(np.float32)
    n_pos = rng.uniform(0, 4, (b, m, 3)).astype(np.float32)
    q_dia = rng.uniform(0.5, 2, b).astype(np.float32)
    n_dia = rng.uniform(0.5, 2, (b, m)).astype(np.float32)
    q_typ = rng.integers(0, 2, b).astype(np.int32)
    n_typ = rng.integers(0, 2, (b, m)).astype(np.int32)
    valid = rng.random((b, m)) < 0.8
    jp, tp = jforces.ForceParams(), tforces.ForceParams()
    jf = jforces.pair_force(*map(jnp.asarray, (q_pos, q_dia, q_typ, n_pos,
                                               n_dia, n_typ, valid)),
                            jp, jnp.asarray(ADH, jnp.float32))
    tf = tforces.pair_force(*map(_t, (q_pos, q_dia, q_typ, n_pos, n_dia,
                                      n_typ, valid)),
                            tp, torch.tensor(ADH))
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=0, atol=1e-5)
    force = rng.normal(0, 5, (b, 3)).astype(np.float32)
    np.testing.assert_allclose(
        tforces.displacement(_t(force), tp, 0.2).numpy(),
        np.asarray(jforces.displacement(jnp.asarray(force), jp, 0.2)),
        rtol=1e-6, atol=1e-7)


def test_k1_wrapper_checks_inputs():
    data = torch.zeros((8, 256))
    cols = torch.full((2, 4), -1, dtype=torch.int32)
    with pytest.raises(ValueError):
        tk1.collision_force(data[:, :200], cols, k_rep=2.0, adhesion=None,
                            adhesion_band=0.4)
    with pytest.raises(ValueError):
        tk1.collision_force(data, cols.long(), k_rep=2.0, adhesion=None,
                            adhesion_band=0.4)
    with pytest.raises(ValueError):
        tk1.collision_force(data, cols, k_rep=2.0,
                            adhesion=torch.zeros((17, 17)),
                            adhesion_band=0.4)
    before = tk1.collision_force.launches
    out = tk1.collision_force(data, cols, k_rep=2.0, adhesion=None,
                              adhesion_band=0.4)
    assert out.shape == (4, 256) and not out.any()
    assert tk1.collision_force.launches == before   # CPU: no kernel launch


@pytest.mark.cuda
@pytest.mark.parametrize("adhesion", [None, ADH])
def test_k1_cuda_kernel_matches_plain(adhesion):
    """The hand-written kernel against its plain version, on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    P, D, T, A, act, starts, counts = _sorted_case(5, 3000, 3200,
                                                   (16, 16, 16), 2.0, 0.7)
    dev = torch.device("cuda")
    args = [_t(x).to(dev) for x in (P, D, T, A, act, starts, counts)]
    before = tk1.collision_force.launches
    gf, gn, go = tops.collision_force_resident(
        *args, torch.zeros(3, device=dev), 2.0, dims=(16, 16, 16), k_rep=2.0,
        adhesion=adhesion, adhesion_band=0.4)
    torch.cuda.synchronize()
    assert tk1.collision_force.launches == before + 1
    cf, cn, co = tops.collision_force_resident(
        *[_t(x) for x in (P, D, T, A, act, starts, counts)], torch.zeros(3),
        2.0, dims=(16, 16, 16), k_rep=2.0, adhesion=adhesion,
        adhesion_band=0.4)
    np.testing.assert_allclose(gf.cpu().numpy(), cf.numpy(), rtol=0,
                               atol=1e-4)
    np.testing.assert_array_equal(gn.cpu().numpy(), cn.numpy())
    assert bool(go) == bool(co)


# ---------------------------------------------------------------------------
# The redesigned K1: its cheap reject, its in-reach count, and (on the card)
# both kernels against their plain versions.
# ---------------------------------------------------------------------------

from hypothesis_compat import given, settings, st  # noqa: E402
from repro_torch.kernels import block_cols as tcolmap  # noqa: E402

F32 = np.float32


def _exact_in_band(d2, r_q, r_n, band):
    """The kernel's (and the plain version's) float32 band test."""
    dist = np.sqrt(np.maximum(d2, F32(1e-18)))
    delta = (r_q + r_n) - dist
    return delta + F32(band) > F32(0)


def _rho(r, band, slack):
    """The kernel's inflated radius of a live agent."""
    half = F32(max(band, 0.0)) * F32(0.5)
    return (np.fmax(r, F32(0)) + half) * F32(slack)


def _fma32(a, b, c):
    """float32 fma(a, b, c): a·b is exact in float64, the sum is rounded
    to float64 and then to float32 (a double rounding, off by one ulp in
    rare ties; the slack's ~30x room covers that)."""
    return (a.astype(np.float64) * b + c).astype(F32)


def _d2_test(d):
    """The kernel's cheap-test d2 of difference vectors d (n, 3):
    fma(dx, dx, fma(dy, dy, dz·dz))."""
    return _fma32(d[:, 0], d[:, 0], _fma32(d[:, 1], d[:, 1],
                                           d[:, 2] * d[:, 2]))


def _reject_passes(d2t, r_q, r_n, band, slack):
    """numpy mirror of the kernel's cheap test: R = rho_q + rho_n, accept
    iff d2t <= R·R, with d2t the test's fused d2 (``_d2_test``)."""
    reach = _rho(r_q, band, slack) + _rho(r_n, band, slack)
    return d2t <= reach * reach


def _edge_pairs(seed, band, n=2048, max_ulps=6):
    """Pairs at the band's edge: the partner at distance fl(fl(r_q + r_n) +
    a) from the row along a random direction (or an axis), moved by up to
    ``max_ulps`` ulps per coordinate; half the diameters in 0.5-12."""
    rng = np.random.default_rng(seed)
    r_q = (rng.uniform(0.5, 12, n) * 0.5).astype(F32)
    r_n = (rng.uniform(0.5, 12, n) * 0.5).astype(F32)
    reach = (r_q + r_n) + F32(band)
    u = rng.normal(size=(n, 3))
    u[: n // 4] = np.eye(3)[rng.integers(0, 3, n // 4)]        # on an axis
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    row = rng.uniform(-50, 50, (n, 3)).astype(F32)
    col = (row + u * reach[:, None]).astype(F32)
    steps = rng.integers(-max_ulps, max_ulps + 1, (n, 3))
    for k in range(1, max_ulps + 1):
        col = np.where(steps >= k, np.nextafter(col, F32(np.inf)), col)
        col = np.where(steps <= -k, np.nextafter(col, F32(-np.inf)), col)
    d = col - row
    d2 = d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2]
    return d2.astype(F32), _d2_test(d), r_q, r_n


@settings(max_examples=40, deadline=None)
@given(seed=st.integers(0, 2 ** 31 - 1),
       band=st.sampled_from([0.0, 0.4, 1e-7, 2.5, -0.3]))
def test_k1_reject_keeps_every_pair_in_band(seed, band):
    """No pair that the exact float32 band test accepts is rejected by the
    kernel's cheap test with the wrapper's slack: at the band's edge (within
    a few ulps), for coincident agents (the 1e-18 clamp) and for diameters
    0.5-12."""
    d2, d2t, r_q, r_n = _edge_pairs(seed, band)
    exact = _exact_in_band(d2, r_q, r_n, band)
    kept = _reject_passes(d2t, r_q, r_n, band, tk1.REACH_SLACK)
    assert exact.any() and (~exact).any()        # the draw straddles the edge
    assert not (exact & ~kept).any(), np.flatnonzero(exact & ~kept)[:5]
    # coincident and nearly coincident agents
    rng = np.random.default_rng(seed)
    n = 512
    r_q = (rng.uniform(0.5, 12, n) * 0.5).astype(F32)
    r_n = (rng.uniform(0.5, 12, n) * 0.5).astype(F32)
    d2 = np.concatenate([np.zeros(n // 2, F32), (10.0 ** rng.uniform(
        -45, -10, n - n // 2)).astype(F32)])
    exact = _exact_in_band(d2, r_q, r_n, band)
    kept = _reject_passes(d2, r_q, r_n, band, tk1.REACH_SLACK)
    assert exact.all() and kept.all()


def test_k1_reject_slack_covers_the_rounding():
    """The slack satisfies the kernel's bound (1 + u)^2.5/(1 - u)^6 <=
    slack, and a dead agent's NaN radius fails the test."""
    u = 2.0 ** -24
    assert F32(tk1.REACH_SLACK) >= (1 + u) ** 2.5 / (1 - u) ** 6
    reach = F32(np.nan) + _rho(F32(1), 0.4, tk1.REACH_SLACK)
    assert not F32(0) <= reach * reach


def test_pairs_in_reach_matches_brute_force():
    """K1's in-reach count (the bound's exact-arithmetic pairs) against a
    numpy loop over every listed (row, candidate) pair."""
    dims, box = (8, 8, 8), 2.0
    P, D, T, A, act, starts, counts = _sorted_case(11, 300, 384, dims, box,
                                                   0.6)
    A = A.copy()
    A[::7] = False                                   # some dead agents
    data_t, cols, ovf, _ = tops.k1_inputs(
        _t(P), _t(D), _t(T), _t(A), _t(act), _t(starts), _t(counts),
        torch.zeros(3), box, dims)
    assert not bool(ovf)
    got = tk1.pairs_in_reach(data_t, cols, adhesion_band=0.4)
    x = data_t.numpy()
    want = 0
    for rb, row_cols in enumerate(cols.numpy()):
        rows = np.arange(rb * 128, rb * 128 + 128)
        for cb in row_cols[row_cols >= 0]:
            cand = np.arange(cb * 128, cb * 128 + 128)
            dx = x[0, cand][None, :] - x[0, rows][:, None]
            dy = x[1, cand][None, :] - x[1, rows][:, None]
            dz = x[2, cand][None, :] - x[2, rows][:, None]
            d2 = dx * dx + dy * dy + dz * dz
            band = _exact_in_band(d2, x[3, rows][:, None] * F32(0.5),
                                  x[3, cand][None, :] * F32(0.5), 0.4)
            alive = (x[5, rows][:, None] > 0.5) & (x[5, cand][None, :] > 0.5)
            want += int((band & alive).sum())
    assert got == want > 0


def test_column_map_wrapper_runs_only_on_the_card():
    """The kernel wrapper takes CUDA tensors only; on CPU tensors
    ``ops.build_block_cols`` runs the plain version and launches nothing."""
    dims = (3, 3, 3)
    starts = torch.zeros(27, dtype=torch.int32)
    counts = torch.zeros(27, dtype=torch.int32)
    cells = torch.zeros((128, 3), dtype=torch.int32)
    act = torch.ones(128, dtype=torch.bool)
    with pytest.raises(ValueError):
        tcolmap.column_map(starts, counts, dims, 4, 8, n_pad=128,
                           cells=cells, row_active=act)
    before = tcolmap.column_map.launches
    cols, ovf = tops.build_block_cols(cells, starts, counts, act, dims, 4)
    assert tcolmap.column_map.launches == before
    assert (cols == -1).all() and not bool(ovf)


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _face_case():
    """Agents in every face, edge and corner box of a 5x5x5 grid."""
    dims, box = (5, 5, 5), 2.0
    lo, hi = 0.05, dims[0] * box - 0.05
    pts = [(x, y, z) for x in (lo, 5.0, hi) for y in (lo, 5.0, hi)
           for z in (lo, 5.0, hi)]
    pos = np.array(pts * 5, np.float32) + np.random.default_rng(3).uniform(
        -0.04, 0.04, (len(pts) * 5, 3)).astype(np.float32)
    pos = np.clip(pos, 0, hi)
    return pos, dims, box


def _column_map_cases():
    """(name, P, A, act, starts, counts, dims, box, [(maxb, span), ...])."""
    cases = []
    for name, args, combos in (
            ("random", (21, 3000, 3200, (16, 16, 16), 2.0, 1.0),
             [(64, 8), (4, 8), (64, 1)]),
            ("over-maxb", (3, 500, 512, (3, 3, 3), 4.0, 1.0), [(2, 8)]),
            ("inactive", (7, 2000, 2100, (12, 12, 12), 2.0, 0.3),
             [(64, 8), (3, 2)])):
        P, D, T, A, act, starts, counts = _sorted_case(*args)
        cases.append((name, P, D, T, A, act, starts, counts, args[3],
                      args[4], combos))
    # a run longer than span: 400 agents in two boxes
    P, D, T, A, act, starts, counts = _sorted_case(
        9, 400, 512, (4, 4, 4), 1.0, 1.0)
    P[:400] = np.float32(0.5)
    keys = tmorton.grid_sort_keys(torch.from_numpy(P), torch.from_numpy(A),
                                  torch.zeros(3), 1.0, (4, 4, 4))
    order = torch.sort(keys, stable=True).indices
    st, ct = tgrid.box_tables(keys[order], 64)
    o = order.numpy()
    cases.append(("long-run", P[o], D[o], T[o], A[o], act[o], st.numpy(),
                  ct.numpy(), (4, 4, 4), 1.0, [(64, 2), (64, 8)]))
    # rows on every domain face
    pos, dims, box = _face_case()
    n = pos.shape[0]
    Pf = np.zeros((n + 40, 3), np.float32)
    Pf[:n] = pos
    Af = np.zeros(n + 40, bool)
    Af[:n] = True
    keys = tmorton.grid_sort_keys(torch.from_numpy(Pf), torch.from_numpy(Af),
                                  torch.zeros(3), box, dims)
    order = torch.sort(keys, stable=True).indices
    st, ct = tgrid.box_tables(keys[order], tmorton.linear_size(dims))
    o = order.numpy()
    z = np.zeros(n + 40, np.float32)
    cases.append(("faces", Pf[o], z + 1.0, z.astype(np.int32), Af[o], Af[o],
                  st.numpy(), ct.numpy(), dims, box, [(64, 8), (3, 8)]))
    # an all-inactive pool
    P, D, T, A, act, starts, counts = _sorted_case(5, 600, 640, (8, 8, 8),
                                                   2.0)
    cases.append(("all-inactive", P, D, T, A, np.zeros_like(act), starts,
                  counts, (8, 8, 8), 2.0, [(64, 8)]))
    return cases


@pytest.mark.cuda
def test_column_map_cuda_kernel_matches_plain():
    """The column-map kernel ≡ its plain version entry for entry, flag for
    flag, from cells and fused with the pack (k1_inputs), on random pools,
    a row block needing more than maxb ids, a run longer than span blocks,
    inactive rows, rows on every domain face and an all-inactive pool."""
    dev = _cuda_or_skip()
    for (name, P, D, T, A, act, starts, counts, dims, box,
         combos) in _column_map_cases():
        c = P.shape[0]
        n_pad = -(-c // 128) * 128
        Pp = np.zeros((n_pad, 3), np.float32)
        Pp[:c] = P
        ap = np.zeros(n_pad, bool)
        ap[:c] = act & A
        cells = tmorton.cell_of(_t(Pp), torch.zeros(3), box, dims)
        for maxb, span in combos:
            want_c, want_o = tops.build_block_cols_plain(
                cells, _t(starts), _t(counts), _t(ap), dims, maxb, span)
            before = tcolmap.column_map.launches
            got_c, got_o = tops.build_block_cols(
                cells.to(dev), _t(starts).to(dev), _t(counts).to(dev),
                _t(ap).to(dev), dims, maxb, span)
            torch.cuda.synchronize()
            assert tcolmap.column_map.launches == before + 1
            np.testing.assert_array_equal(got_c.cpu().numpy(),
                                          want_c.numpy(), err_msg=name)
            assert bool(got_o) == bool(want_o), (name, maxb, span)
        args = [_t(x) for x in (P, D, T, A, act, starts, counts)]
        want = tops.k1_inputs_plain(*args, torch.zeros(3), box, dims)
        got = tops.k1_inputs(*[a.to(dev) for a in args],
                             torch.zeros(3, device=dev), box, dims)
        torch.cuda.synchronize()
        for g, w, what in zip(got, want, ("data_t", "block_cols", "overflow",
                                          "row mask")):
            assert g.dtype == w.dtype, (name, what)
            np.testing.assert_array_equal(g.cpu().numpy(), w.numpy(),
                                          err_msg=f"{name}: {what}")
    # the Fig-6 pool after the engine's resident build, on the card
    from repro_torch.core import engine as eng
    from repro_torch.launch import simulate
    sim, st = simulate.build("proliferation", 32768, "fig6", device="cuda")
    cfg, spec = sim.config, sim.spec
    origin = torch.tensor(cfg.domain_lo, dtype=torch.float32, device=dev)
    res = eng.build_env(cfg, spec, st.pool, origin, cfg.cell_size)
    pool, g = res.pool, res.grid
    args = (pool.position, pool.diameter, pool.agent_type, pool.alive,
            pool.alive, g.starts, g.counts, origin, cfg.cell_size, spec.dims)
    for gt, w in zip(tops.k1_inputs(*args), tops.k1_inputs_plain(*args)):
        assert gt.dtype == w.dtype and torch.equal(gt, w)


def _band_edge_data(n_types=16):
    """K1 inputs with dead agents, a 16-type adhesion table, row blocks that
    list every block (self pairs) but one with an empty list, and isolated
    pairs on an axis 1 ulp either side of the band's edge."""
    rng = np.random.default_rng(17)
    n_pad = 512
    x = np.zeros((8, n_pad), np.float32)
    x[0:3] = rng.uniform(0, 12, (3, n_pad))          # a dense cluster
    x[3] = rng.uniform(0.5, 4, n_pad)
    x[4] = rng.integers(0, n_types, n_pad)
    x[5] = rng.random(n_pad) < 0.85
    band = np.float32(0.4)
    # pairs (2i, 2i+1) of rows 256..383: on the x axis, far from the rest
    for i, a in enumerate(range(256, 384, 2)):
        r_q, r_n = np.float32(x[3, a] * 0.5), np.float32(x[3, a + 1] * 0.5)
        base = np.float32(100 + 20 * i)
        xb = np.float32(base + ((r_q + r_n) + band))
        inside = _exact_in_band(np.float32((xb - base) ** 2), r_q, r_n, band)
        step = np.float32(np.inf if inside else -np.inf)
        # walk to the last partner position inside the band, then 1 ulp out
        # for odd i
        while True:
            nxt = np.nextafter(xb, step)
            d = np.float32(nxt - base)
            if _exact_in_band(np.float32(d * d), r_q, r_n, band) != inside:
                break
            xb = nxt
        if not inside:
            xb = np.nextafter(xb, step)            # the first one inside
        if i % 2:
            xb = np.nextafter(xb, np.float32(np.inf))   # 1 ulp outside
        x[0:3, a] = (base, 50, 50)
        x[0:3, a + 1] = (xb, 50, 50)
        x[5, a] = x[5, a + 1] = 1
    cols = np.full((n_pad // 128, 6), -1, np.int32)
    cols[0, :4] = [0, 1, 2, 3]
    cols[1, :3] = [0, 1, 3]
    cols[2, :1] = [2]
    # row block 3: an empty list
    adh = rng.uniform(0, 1, (n_types, n_types)).astype(np.float32)
    return x, cols, adh


@pytest.mark.cuda
@pytest.mark.parametrize("with_adhesion", [False, True])
def test_k1_cuda_kernel_matches_plain_at_the_band_edge(with_adhesion):
    """K1 ≡ its plain version (force atol 1e-4, nnz exact) on dead agents,
    self pairs, a 16-type adhesion table, an empty list and pairs 1 ulp
    either side of the band."""
    dev = _cuda_or_skip()
    x, cols, adh = _band_edge_data()
    data, blocks = torch.from_numpy(x), torch.from_numpy(cols)
    table = torch.from_numpy(adh) if with_adhesion else None
    kw = dict(k_rep=2.0, adhesion_band=0.4)
    want = tk1.collision_force_plain(data, blocks, adhesion=table, **kw)
    edge_nnz = want[3, 256:384].reshape(-1, 2)[:, 0].numpy()
    assert not edge_nnz[1::2].any()
    if with_adhesion:              # inside the band only adhesion acts
        assert edge_nnz[0::2].all()
    before = tk1.collision_force.launches
    got = tk1.collision_force(data.to(dev), blocks.to(dev),
                              adhesion=None if table is None
                              else table.to(dev), **kw).cpu()
    assert tk1.collision_force.launches == before + 1
    np.testing.assert_allclose(got[:3].numpy(), want[:3].numpy(), rtol=0,
                               atol=1e-4)
    np.testing.assert_array_equal(got[3].numpy(), want[3].numpy())
    assert not got[:, 384:].any()                  # the empty list


K_REP, FORCE_EPS = 2.0, 1e-7


def _nnz_bit(d2, r=F32(1.5), k_rep=K_REP):
    """K1's nnz bit (f² > 1e-14) of a pair of radius-r agents at squared
    distance d2, in float32 as the kernel and its plain version form it."""
    dist = np.sqrt(np.maximum(d2, F32(1e-18)))
    delta = (r + r) - dist
    r_eff = np.maximum(r * r / np.maximum(r + r, F32(1e-12)), F32(1e-12))
    f = F32(k_rep) * np.sqrt(r_eff) * np.power(np.maximum(delta, F32(0)),
                                               F32(1.5))
    return f * f > F32(1e-14)


def _nnz_threshold_data(seed=23, n_pairs=128, tries=64):
    """K1 inputs (8, 2·n_pairs) of isolated pairs of diameter-3 agents,
    each at a distance that puts its force within a few percent of
    force_eps (1e-7) along a random direction. For each pair slot the first
    of ``tries`` draws whose nnz bit differs between the plain d2, ((dx² +
    dy²) + dz²) rounded at each step, and the fused fma(dx, dx, fma(dy, dy,
    dz²)) is kept, else the first draw. Returns data, block_cols and the
    mask of pairs whose bit the fused d2 flips."""
    rng = np.random.default_rng(seed)
    delta_eps = (FORCE_EPS / (K_REP * np.sqrt(0.75))) ** (2 / 3)
    slot = np.arange(n_pairs)
    lattice = np.stack([slot % 8, slot // 8 % 8, slot // 64], -1) * 10.0
    base = (lattice[:, None] + 20 + rng.uniform(0, 1, (n_pairs, tries, 3))
            ).astype(F32)
    u = rng.normal(size=(n_pairs, tries, 3))
    u /= np.linalg.norm(u, axis=-1, keepdims=True)
    dist = 3.0 - delta_eps * (1 + rng.uniform(-0.03, 0.03, (n_pairs, tries)))
    partner = (base + u * dist[..., None]).astype(F32)
    d = (partner - base).reshape(-1, 3)
    d2 = (d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]) + d[:, 2] * d[:, 2]
    flips = (_nnz_bit(d2) != _nnz_bit(_d2_test(d))).reshape(n_pairs, tries)
    pick = np.where(flips.any(1), flips.argmax(1), 0)
    x = np.zeros((8, 2 * n_pairs), np.float32)
    x[0:3, 0::2] = base[slot, pick].T
    x[0:3, 1::2] = partner[slot, pick].T
    x[3], x[5] = 3.0, 1.0
    cols = np.full((2 * n_pairs // 128, 4), -1, np.int32)
    cols[:, :cols.shape[0]] = np.arange(cols.shape[0])
    return x, cols, flips[slot, pick]


def test_k1_nnz_threshold_pairs_tell_the_two_d2_forms_apart():
    """The threshold fixture holds pairs whose nnz bit the fused d2 would
    flip (the card's test of K1 against its plain version needs them), and
    the plain version counts each isolated pair at most once per row, the
    same for both of its agents."""
    x, cols, flips = _nnz_threshold_data()
    assert flips.sum() >= 16, int(flips.sum())
    out = tk1.collision_force_plain(torch.from_numpy(x),
                                    torch.from_numpy(cols), k_rep=K_REP,
                                    adhesion=None, adhesion_band=0.4)
    nnz = out[3].numpy().reshape(-1, 2)
    assert set(np.unique(nnz)) <= {0.0, 1.0}
    np.testing.assert_array_equal(nnz[:, 0], nnz[:, 1])
    assert 0 < nnz[:, 0].sum() < len(nnz)        # both sides of the threshold


@pytest.mark.cuda
def test_k1_cuda_kernel_nnz_at_the_force_threshold():
    """K1 ≡ its plain version on the card (force atol 1e-4, nnz exact) on
    pairs whose force lies within float32 rounding of force_eps, where a
    d2 contracted into FMAs would count other pairs than the plain
    version."""
    dev = _cuda_or_skip()
    x, cols, _ = _nnz_threshold_data()
    data, blocks = torch.from_numpy(x).to(dev), torch.from_numpy(cols).to(dev)
    kw = dict(k_rep=K_REP, adhesion=None, adhesion_band=0.4)
    want = tk1.collision_force_plain(data, blocks, **kw).cpu()
    got = tk1.collision_force(data, blocks, **kw).cpu()
    np.testing.assert_allclose(got[:3].numpy(), want[:3].numpy(), rtol=0,
                               atol=1e-4)
    np.testing.assert_array_equal(got[3].numpy(), want[3].numpy())


def test_k1_variants_follow_the_source():
    """launch/k1_variants.py builds its variants from the kernel source by
    text substitution: each must change the source, and only where meant."""
    from repro_torch.launch import k1_variants
    srcs = k1_variants.variant_sources()
    base = srcs["committed"]
    assert set(srcs) == {"committed", "rows1", "rows4", "no_exact",
                         "test_only"}
    for name, text in srcs.items():
        assert (text == base) == (name == "committed"), name
    assert "kRows = 4;" in srcs["rows4"] and "kRows = 1;" in srcs["rows1"]


# ---------------------------------------------------------------------------
# The pair-list build and the column map from a pair list
# ---------------------------------------------------------------------------

from repro_torch.core.agents import make_pool  # noqa: E402
from repro_torch.kernels import pair_cols as tpaircols  # noqa: E402
from repro_torch.kernels import build as tbuild  # noqa: E402
from repro_torch.kernels import pairlist as tpairlist  # noqa: E402


def test_pairlist_variants_follow_the_source():
    """launch/kernel_variants.py keeps the first designs of the pair-list,
    pairs column-map, secretion and K2 kernels as sources of their own:
    each is there, with an entry point whose arguments the argument list
    it is called with fits."""
    import re
    from repro_torch.kernels import flash_attention as tk2
    from repro_torch.launch import kernel_variants
    assert set(kernel_variants.FIRST) == {"pairlist_warp_row",
                                          "pair_cols_row_walk",
                                          "secretion_sorted",
                                          "flash_attention_first"}
    want = {"pairlist_warp_row": tpairlist.ARGTYPES,
            "pair_cols_row_walk": tpaircols.ARGTYPES,
            "secretion_sorted": kernel_variants.SECRETION_ARGTYPES,
            "flash_attention_first": tk2.ARGTYPES}
    for name, entry in kernel_variants.FIRST.items():
        text = (kernel_variants._DIR / f"{name}.cu").read_text()
        sig = re.search(r'extern "C" int ' + entry + r"\(([^)]*)\)", text)
        assert sig and len(sig.group(1).split(",")) == len(want[name]), name
        assert kernel_variants.ARGTYPES[name] == want[name]


def _radius_pairs(n=2048, r=4.0, seed=11):
    """Agents and their partners (n/2 each, float32) at distance r in
    random directions, each pair 20 apart from the others."""
    rng = np.random.default_rng(seed)
    side = int(np.ceil(np.sqrt(n / 2))) + 1
    base = np.stack(np.meshgrid(np.arange(side), np.arange(side), [0]),
                    -1).reshape(-1, 3)[:n // 2] * 20.0 + 10.0
    u = rng.normal(size=(n // 2, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    return base.astype(np.float32), (base + r * u).astype(np.float32), side


def _radius_case(n=2048, r=4.0, seed=11):
    """The pairs of :func:`_radius_pairs`: float32 d2 lands within a few
    ulps of r², where a d2 contracted into FMAs keeps other pairs than the
    plain version's. Returns (spec, grid, position, alive) of the resident
    build, every third agent dead."""
    base, partner, side = _radius_pairs(n, r, seed)
    pos = np.concatenate([base, partner])
    alive = np.arange(n) % 3 != 2
    dims = (int(np.ceil((side * 20.0 + 10) / r)),) * 2 + (4,)
    spec = tgrid.GridSpec(dims=dims, max_per_box=8)
    pool = make_pool(n, position=pos, diameter=np.ones(n, np.float32),
                     device="cpu")
    pool = dataclasses.replace(pool, alive=_t(alive))
    res = tgrid.make_builder(spec)(pool, torch.zeros(3), r)
    return spec, res.grid, res.pool.position, res.pool.alive


def _grid_to(g, dev):
    return dataclasses.replace(g, **{f.name: getattr(g, f.name).to(dev)
                                     for f in dataclasses.fields(g)
                                     if isinstance(getattr(g, f.name),
                                                   torch.Tensor)})


def _pairlist_cases():
    """(name, spec, grid, position, alive, radius, max_pairs) on the CPU:
    a random pool with dead rows and an inactive half, the same with a
    table too narrow (overflow rows), pairs at the radius, and a run
    longer than run_capacity."""
    cases = []
    P, D, T, A, act, starts, counts = _sorted_case(21, 3000, 3200,
                                                   (16, 16, 16), 2.0)
    spec = tgrid.GridSpec(dims=(16, 16, 16), max_per_box=8)
    g = tgrid.GridState(origin=torch.zeros(3), box_size=2.0, keys=None,
                        order=None, rank=None, starts=_t(starts),
                        counts=_t(counts), max_count=None,
                        max_run_count=None)
    for name, radius, mp in (("random", 2.0, 64), ("overflow", 2.0, 3),
                             ("skin", 2.7, 96)):
        cases.append((name, spec, g, _t(P), _t(A), radius, mp))
    cases.append(("at-the-radius", *_radius_case(), 4.0, 8))
    # 400 agents in two boxes: runs longer than run_capacity (24)
    P2 = P.copy()
    P2[:400] = np.float32(0.5) + np.random.default_rng(2).uniform(
        0, 1.4, (400, 3)).astype(np.float32)
    keys = tmorton.grid_sort_keys(_t(P2), _t(A), torch.zeros(3), 2.0,
                                  (16, 16, 16))
    order = torch.sort(keys, stable=True).indices
    st_, ct_ = tgrid.box_tables(keys[order], 16 ** 3)
    g2 = tgrid.GridState(origin=torch.zeros(3), box_size=2.0, keys=None,
                         order=None, rank=None, starts=st_, counts=ct_,
                         max_count=None, max_run_count=None)
    cases.append(("long-run", spec, g2, _t(P2)[order], _t(A)[order], 2.0,
                  32))
    return cases


def _pairs_equal(got, want, name):
    for f in ("idx", "run_off", "count", "demand"):
        g, w = getattr(got, f), getattr(want, f)
        assert g.dtype == w.dtype == torch.int32, (name, f)
        np.testing.assert_array_equal(g.cpu().numpy(), w.cpu().numpy(),
                                      err_msg=f"{name}: {f}")


def test_pairlist_at_the_radius_case_splits_on_rounding():
    """The at-the-radius case keeps some pairs and drops others, and
    rounding d2 with an FMA would decide some of them otherwise: the card
    test below can tell a contracted d2 from the plain one."""
    spec, g, pos, alive = _radius_case()
    pl = tgrid.build_pairlist_plain(spec, g, pos, alive, radius=4.0,
                                    max_pairs=8)
    kept = int(pl.count.sum())
    assert 0 < kept < 2 * int(alive.sum())
    # the pairs themselves: d2 rounded as the plain version vs one FMA
    base, partner, _ = _radius_pairs()
    dd = partner - base
    plain = np.float32(np.float32(dd[:, 0] * dd[:, 0])
                       + np.float32(dd[:, 1] * dd[:, 1])) \
        + np.float32(dd[:, 2] * dd[:, 2])
    fused = np.float32(np.float64(dd[:, 2]) * dd[:, 2] + np.float64(
        np.float32(np.float32(dd[:, 0] * dd[:, 0])
                   + np.float32(dd[:, 1] * dd[:, 1]))))
    assert ((plain <= 16.0) != (fused <= 16.0)).any()


def test_pairlist_wrapper_runs_the_plain_version_on_the_cpu():
    before = tpairlist.build_list.launches
    for name, spec, g, pos, alive, radius, mp in _pairlist_cases():
        got = tgrid.build_pairlist(spec, g, pos, alive, radius=radius,
                                   max_pairs=mp)
        want = tgrid.build_pairlist_plain(spec, g, pos, alive, radius=radius,
                                          max_pairs=mp, chunk=7)
        _pairs_equal(got, want, name)
    assert tpairlist.build_list.launches == before
    with pytest.raises(ValueError):
        tpairlist.build_list(pos, alive, torch.zeros(3), 4.0,
                             g.starts, g.counts, spec.dims, 24, 16.0, 8)


@pytest.mark.parametrize("bad", ["cpu", "position", "alive", "lanes",
                                 "tables", "origin", "max_pairs",
                                 "run_capacity"])
def test_pairlist_wrapper_raises_on_cpu_tensors_and_bad_shapes(bad):
    """kernels/pairlist.build_list takes CUDA tensors of the kernel's
    shapes only: CPU tensors, and each shape it does not take, raise
    ValueError before anything is built or launched."""
    c, dims = 64, (2, 2, 2)
    kw = dict(position=torch.zeros((c, 3)),
              alive=torch.ones(c, dtype=torch.bool), origin=torch.zeros(3),
              box_size=2.0, starts=torch.zeros(8, dtype=torch.int32),
              counts=torch.zeros(8, dtype=torch.int32), dims=dims,
              run_capacity=24, r2=4.0, max_pairs=8, lanes=1)
    if bad == "position":
        kw["position"] = torch.zeros((c, 2))
    elif bad == "alive":
        kw["alive"] = torch.ones(c + 1, dtype=torch.bool)
    elif bad == "lanes":
        kw["lanes"] = 3
    elif bad == "tables":
        kw["starts"] = torch.zeros(9, dtype=torch.int32)
    elif bad == "origin":
        kw["origin"] = torch.zeros(2)
    elif bad == "max_pairs":
        kw["max_pairs"] = 0
    elif bad == "run_capacity":
        kw["run_capacity"] = -1
    before = tpairlist.build_list.launches
    with pytest.raises(ValueError):
        tpairlist.build_list(**kw)
    assert tpairlist.build_list.launches == before


@pytest.mark.cuda
def test_pairlist_cuda_kernel_matches_plain():
    """The pair-list kernel ≡ its plain version, entry for entry (idx,
    run_off, count, demand), on a random pool with dead rows, an overflow
    case, a skin radius, pairs at the radius and runs past run_capacity,
    and on the forces + SIR pool after the engine's build."""
    dev = _cuda_or_skip()
    for name, spec, g, pos, alive, radius, mp in _pairlist_cases():
        want = tgrid.build_pairlist_plain(spec, g, pos, alive, radius=radius,
                                          max_pairs=mp)
        before = tpairlist.build_list.launches
        got = tgrid.build_pairlist(spec, _grid_to(g, dev), pos.to(dev),
                                   alive.to(dev), radius=radius,
                                   max_pairs=mp)
        torch.cuda.synchronize()
        assert tpairlist.build_list.launches == before + 1
        _pairs_equal(got, want, name)
    from repro_torch.core import engine as eng
    from repro_torch.launch import simulate
    sim, st = simulate.build("epidemiology", 32768, "breakdown",
                             device="cuda")
    cfg, spec = sim.config, sim.spec
    origin = torch.zeros(3, device=dev)
    res = eng.build_env(cfg, spec, st.pool, origin, cfg.cell_size)
    for radius, mp in ((4.0, 64), (4.0, 8), (5.5, 128)):
        got = tgrid.build_pairlist(spec, res.grid, res.pool.position,
                                   res.pool.alive, radius=radius,
                                   max_pairs=mp)
        want = tgrid.build_pairlist_plain(spec, res.grid, res.pool.position,
                                          res.pool.alive, radius=radius,
                                          max_pairs=mp)
        _pairs_equal(got, want, f"breakdown r={radius} P={mp}")


_PAIRLIST_K = tbuild.constants("pairlist")
TILE_ROWS = _PAIRLIST_K["kRows"]        # rows a block of csrc/pairlist.cu
STAGE_MAX = _PAIRLIST_K["kStageMax"]    # candidates a block stages


def _grid_ordered(pos, alive, dims, box):
    """A pool in grid order with its tables (the engine's resident layout):
    (position, alive, starts, counts) tensors."""
    P, A = _t(pos), _t(alive)
    keys = tmorton.grid_sort_keys(P, A, torch.zeros(3), box, dims)
    order = torch.sort(keys, stable=True).indices
    starts, counts = tgrid.box_tables(keys[order], tmorton.linear_size(dims))
    return P[order], A[order], starts, counts


def _grid_state(starts, counts, box, rows):
    return tgrid.GridState(origin=torch.zeros(3), box_size=box,
                           keys=torch.zeros(rows, dtype=torch.int64),
                           order=None, rank=None, starts=starts,
                           counts=counts, max_count=None, max_run_count=None)


def _pairlist_any_order_case(name):
    """(spec, grid, position, alive, radius, max_pairs) on the CPU, one
    case a branch of the pair-list kernel: rows not in grid order (tables
    kept), tiles that straddle columns, a row whose own runs are past the
    staged budget, tiles whose union of runs is past it though each row's
    own runs fit, 16 ensemble lanes, no rows, and a row count that is not
    a multiple of the tile."""
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    if name == "shuffled":
        P, _, _, A, _, starts, counts = _sorted_case(21, 3000, 3200,
                                                     (16, 16, 16), 2.0)
        perm = rng.permutation(len(P))
        spec = tgrid.GridSpec(dims=(16, 16, 16), max_per_box=8)
        return (spec, _grid_state(_t(starts), _t(counts), 2.0, len(P)),
                _t(P[perm]), _t(A[perm]), 2.0, 64)
    if name == "straddle":             # ~250 rows a column
        dims = (4, 4, 64)
        pos = rng.uniform(0, 1, (4000, 3)) * np.array([8.0, 8.0, 128.0])
        P, A, starts, counts = _grid_ordered(
            pos.astype(np.float32), rng.random(4000) < 0.9, dims, 2.0)
        spec = tgrid.GridSpec(dims=dims, max_per_box=16)
        return (spec, _grid_state(starts, counts, 2.0, len(P)), P, A, 2.0,
                64)
    if name == "long-runs":            # ~220 agents a box
        dims = (3, 3, 3)
        pos = rng.uniform(0, 5.94, (6000, 3)).astype(np.float32)
        P, A, starts, counts = _grid_ordered(pos, np.ones(6000, bool), dims,
                                             2.0)
        spec = tgrid.GridSpec(dims=dims, max_per_box=400)
        return (spec, _grid_state(starts, counts, 2.0, len(P)), P, A, 1.0,
                64)
    if name == "wide-union":           # ~19 agents a box, 6x6 columns
        dims, n = (6, 6, 16), 11008
        pos = rng.uniform(0, 1, (n, 3)) * np.array([12.0, 12.0, 32.0])
        P, A, starts, counts = _grid_ordered(
            pos.astype(np.float32), rng.random(n) < 0.9, dims, 2.0)
        spec = tgrid.GridSpec(dims=dims, max_per_box=40)
        return (spec, _grid_state(starts, counts, 2.0, len(P)), P, A, 2.0,
                64)
    if name == "16-lanes":
        dims, c = (8, 8, 8), 1000
        parts = [_sorted_case(40 + lane, 900, c, dims, 2.0)
                 for lane in range(16)]
        P = np.concatenate([x[0] for x in parts])
        A = np.concatenate([x[3] for x in parts])
        starts = np.concatenate([x[5] + lane * c
                                 for lane, x in enumerate(parts)])
        counts = np.concatenate([x[6] for x in parts])
        spec = tgrid.GridSpec(dims=dims, max_per_box=8)
        return (spec, _grid_state(_t(starts), _t(counts), 2.0, len(P)),
                _t(P), _t(A), 2.0, 32)
    if name == "empty":
        spec = tgrid.GridSpec(dims=(4, 4, 4), max_per_box=8)
        zeros = torch.zeros(64, dtype=torch.int32)
        return (spec, _grid_state(zeros, zeros, 2.0, 0),
                torch.zeros((0, 3)), torch.zeros(0, dtype=torch.bool), 2.0, 8)
    assert name == "ragged"
    P, _, _, A, _, starts, counts = _sorted_case(22, 2900, 3001,
                                                 (16, 16, 16), 2.0)
    spec = tgrid.GridSpec(dims=(16, 16, 16), max_per_box=8)
    return (spec, _grid_state(_t(starts), _t(counts), 2.0, len(P)), _t(P),
            _t(A), 2.5, 16)


PAIRLIST_ANY_ORDER = ["shuffled", "straddle", "long-runs", "wide-union",
                      "16-lanes", "empty", "ragged"]


def _tile_unions(spec, g, pos, alive):
    """(tiles,) the records csrc/pairlist.cu would stage for each 32-row
    tile of a one-lane pool: the runs of its first and its last live
    row's columns' 9 neighbouring columns over the z span of the tile's
    live rows in each (the kernel's step 1)."""
    dims = spec.dims
    cells = tmorton.cell_of(pos, g.origin, g.box_size, dims).numpy()
    starts, counts = g.starts.numpy(), g.counts.numpy()
    live = alive.numpy()
    out = []
    for r0 in range(0, len(cells), TILE_ROWS):
        c, lv = cells[r0:r0 + TILE_ROWS], live[r0:r0 + TILE_ROWS]
        rows = np.flatnonzero(lv)
        total = 0
        for col in {tuple(c[rows[0], :2]), tuple(c[rows[-1], :2])} \
                if len(rows) else ():
            z = c[rows[(c[rows, :2] == col).all(1)], 2]
            z_lo, z_hi = max(z.min() - 1, 0), min(z.max() + 1, dims[2] - 1)
            for k in range(9):
                nx, ny = col[0] + k // 3 - 1, col[1] + k % 3 - 1
                if 0 <= nx < dims[0] and 0 <= ny < dims[1]:
                    base = (nx * dims[1] + ny) * dims[2]
                    total += max(int(starts[base + z_hi] + counts[base + z_hi]
                                     - starts[base + z_lo]), 0)
        out.append(total)
    return np.array(out)


def test_pairlist_any_order_cases_reach_every_branch():
    """Each case above is what it says: rows out of grid order, 32-row
    tiles whose live rows lie in two columns, a row whose 9 runs alone
    hold more candidates than a block stages, tiles whose staged union
    would be past that budget though every row's own 9 runs are within it
    (beside tiles that stage), 16 lanes of tables, no rows, a ragged last
    tile; and the plain list of each is non-trivial."""
    for name in PAIRLIST_ANY_ORDER:
        spec, g, pos, alive, radius, mp = _pairlist_any_order_case(name)
        c = pos.shape[0]
        pl = tgrid.build_pairlist_plain(spec, g, pos, alive, radius=radius,
                                        max_pairs=mp)
        assert pl.idx.shape == (c, mp), name
        if name == "empty":
            assert c == 0 and int(pl.demand) == 0
            continue
        assert int(pl.count.sum()) > 0, name
        cells = tmorton.cell_of(pos, g.origin, g.box_size, spec.dims)
        keys = tmorton.linear_encode3(cells[:, 0], cells[:, 1],
                                      cells[:, 2], spec.dims)
        live = keys[alive]
        if name == "shuffled":
            assert (live[1:] < live[:-1]).any()
        if name == "straddle":
            col = (cells[:, 0] * spec.dims[1] + cells[:, 1])
            n_tiles = c // TILE_ROWS
            cols = col[:n_tiles * TILE_ROWS].reshape(n_tiles, TILE_ROWS)
            assert ((cols != cols[:, :1]).any(1)).sum() >= 8
        if name in ("long-runs", "wide-union"):
            _, n = tgrid.run_bounds(spec, g, pos)
            own = int(n.clamp(max=spec.run_capacity).sum(1).max())
            assert (own > STAGE_MAX) == (name == "long-runs"), (name, own)
            assert int(pl.demand) > mp
        if name == "wide-union":
            unions = _tile_unions(spec, g, pos, alive)
            assert (unions > STAGE_MAX).sum() >= 20
            assert ((unions > 0) & (unions <= STAGE_MAX)).sum() >= 8
        if name == "16-lanes":
            assert g.starts.shape[0] == 16 * spec.table_size
            assert pl.demand.shape == (16,)
        if name == "ragged":
            assert c % TILE_ROWS != 0


@pytest.mark.cuda
@pytest.mark.parametrize("name", PAIRLIST_ANY_ORDER)
def test_pairlist_cuda_kernel_matches_plain_in_any_row_order(name):
    """The pair-list kernel ≡ its plain version entry for entry (idx,
    run_off, count, demand) on each case above: the staged branch, the
    global branch and both in one tile; one launch a build; two card
    builds bit-equal."""
    dev = _cuda_or_skip()
    spec, g, pos, alive, radius, mp = _pairlist_any_order_case(name)
    want = tgrid.build_pairlist_plain(spec, g, pos, alive, radius=radius,
                                      max_pairs=mp)
    gd, pd, ad = _grid_to(g, dev), pos.to(dev), alive.to(dev)
    before = tpairlist.build_list.launches
    runs = [tgrid.build_pairlist(spec, gd, pd, ad, radius=radius,
                                 max_pairs=mp) for _ in range(2)]
    torch.cuda.synchronize()
    assert tpairlist.build_list.launches == before + 2
    for got in runs:
        _pairs_equal(got, want, name)


def _synthetic_pairs(seed=4, c=300, p=12, spread=2 ** 26):
    """A pair list whose rows name column blocks far apart (more than one
    32,768-block window of the kernel's bitmap) and near each other."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, spread, (c, p)).astype(np.int32)
    idx[::2] = rng.integers(0, 50_000, (len(idx[::2]), p))
    stored = rng.integers(0, p + 1, c)
    off = np.zeros((c, 10), np.int32)
    off[:, 1:] = np.minimum(np.sort(rng.integers(0, p + 1, (c, 9)), 1),
                            stored[:, None])
    off[:, 9] = stored
    return tgrid.PairList(idx=_t(idx), run_off=_t(off),
                          count=_t(stored.astype(np.int32)),
                          demand=torch.tensor(int(stored.max()),
                                              dtype=torch.int32))


def test_pairs_column_map_wrapper_runs_the_plain_version_on_the_cpu():
    pairs = _synthetic_pairs()
    act = torch.ones(384, dtype=torch.bool)
    before = tpaircols.column_map_from_pairs.launches
    cols, ovf = tops.build_block_cols_from_pairs(pairs, act, 384, 64)
    want, wovf = tops.build_block_cols_from_pairs_plain(pairs, act, 384, 64)
    assert tpaircols.column_map_from_pairs.launches == before
    assert torch.equal(cols, want) and bool(ovf) == bool(wovf)
    with pytest.raises(ValueError):
        tpaircols.column_map_from_pairs(pairs.idx, pairs.run_off, 384, 64,
                                        row_active=act)


@pytest.mark.cuda
def test_pairs_column_map_cuda_kernel_matches_plain():
    """The pairs column-map kernel ≡ its plain version, entry for entry and
    flag for flag, from the row mask and fused with the pack (k1_inputs),
    on pair lists of the cases above, a synthetic list spanning several
    bitmap windows, and maxb below the need."""
    dev = _cuda_or_skip()
    lists = []
    for name, spec, g, pos, alive, radius, mp in _pairlist_cases():
        lists.append((name, tgrid.build_pairlist_plain(
            spec, g, pos, alive, radius=radius, max_pairs=mp), alive))
    syn = _synthetic_pairs()
    lists.append(("synthetic", syn, torch.arange(300) % 5 != 0))
    for name, pairs, act in lists:
        c = pairs.idx.shape[0]
        n_pad = -(-c // 128) * 128
        ap = torch.nn.functional.pad(act, (0, n_pad - c))
        dpairs = tgrid.PairList(*(x.to(dev) for x in (
            pairs.idx, pairs.run_off, pairs.count, pairs.demand)))
        for maxb in (64, 4):
            want = tops.build_block_cols_from_pairs_plain(pairs, ap, n_pad,
                                                          maxb)
            before = tpaircols.column_map_from_pairs.launches
            got = tops.build_block_cols_from_pairs(dpairs, ap.to(dev), n_pad,
                                                   maxb)
            torch.cuda.synchronize()
            assert tpaircols.column_map_from_pairs.launches == before + 1
            np.testing.assert_array_equal(got[0].cpu().numpy(),
                                          want[0].numpy(), err_msg=name)
            assert bool(got[1]) == bool(want[1]), (name, maxb)
        rng = np.random.default_rng(1)
        pool = [_t(rng.uniform(0, 9, (c, 3)).astype(np.float32)),
                _t(rng.uniform(1, 3, c).astype(np.float32)),
                _t(rng.integers(0, 3, c).astype(np.int32)), act,
                _t(rng.random(c) < 0.7)]
        tables = (torch.zeros(8, dtype=torch.int32),) * 2
        want = tops.k1_inputs_plain(*pool, *tables, torch.zeros(3), 2.0,
                                    (2, 2, 2), 64, pairs)
        got = tops.k1_inputs(*[x.to(dev) for x in pool],
                             *(x.to(dev) for x in tables),
                             torch.zeros(3, device=dev), 2.0, (2, 2, 2), 64,
                             dpairs)
        torch.cuda.synchronize()
        for gt, w, what in zip(got, want, ("data_t", "block_cols",
                                           "overflow", "row mask")):
            assert gt.dtype == w.dtype, (name, what)
            np.testing.assert_array_equal(gt.cpu().numpy(), w.numpy(),
                                          err_msg=f"{name}: {what}")


PAIRS_MAP_CASES = ["full-rows", "full-rows-128", "wide-span",
                   "wide-span-full", "overflow-lanes", "16-lanes",
                   "permuted", "none-stored", "no-rows"]


def _run_off_of(stored, rng):
    """run_off rows whose last entry (what the map reads) is ``stored``."""
    c = len(stored)
    off = np.zeros((c, 10), np.int32)
    off[:, 1:] = np.minimum(np.sort(rng.integers(0, 129, (c, 9)), 1),
                            stored[:, None])
    off[:, 9] = stored
    return off


def _pairs_map_case(name):
    """A pair list for the pairs column map on the CPU: ``(PairList,
    row_active (n_pad,) bool, n_pad, maxb, lanes, lane capacity)``.
    full-rows: every row stores max_pairs (64) entries, near its own row
    (8,192 entries a row block, past the kernel's staging); full-rows-128:
    the same at max_pairs 128; wide-span: column ids across many 32,768-
    block windows; wide-span-full: the same with every row storing 64
    entries (8,192 a row block, so each window stages its chunks again);
    overflow-lanes: 2 lanes, the second needing more column
    blocks than maxb; 16-lanes: 16 lanes of 200 rows, packed at 256;
    permuted: a neighbour list of a pool whose rows were shuffled;
    none-stored: rows that store nothing; no-rows: a list of no rows."""
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    lanes, cap, maxb = 1, 0, 64
    if name in ("full-rows", "full-rows-128", "permuted"):
        c, p = (1000, 64) if name != "full-rows-128" else (700, 128)
        idx = np.clip(np.arange(c)[:, None]
                      + rng.integers(-600, 600, (c, p)), 0, c - 1)
        stored = (np.full(c, p) if name != "permuted"
                  else rng.integers(0, p + 1, c))
        if name == "permuted":
            perm = rng.permutation(c)
            inv = np.argsort(perm)
            idx, stored = inv[idx[perm]], stored[perm]
    elif name == "wide-span":
        c, p = 600, 16
        idx = rng.integers(0, 2 ** 26, (c, p))
        idx[::3] = rng.integers(0, 3000, (len(idx[::3]), p))
        stored = rng.integers(0, p + 1, c)
        maxb = 4096
    elif name == "wide-span-full":
        c, p = 256, 64
        idx = rng.integers(0, 2 ** 24, (c, p))
        stored = np.full(c, p)
        maxb = 8192
    elif name in ("overflow-lanes", "16-lanes"):
        lanes, cap, p = (2, 300, 12) if name == "overflow-lanes" \
            else (16, 200, 24)
        c = lanes * cap
        lane_of = np.arange(c)[:, None] // cap
        if name == "overflow-lanes":
            # lane 0 lists slots of its first block only, lane 1 all its
            # 300 slots: 3 packed column blocks, past maxb 2
            spread = np.where(lane_of == 0, 40, cap)
            idx = lane_of * cap + rng.integers(0, 1 << 20, (c, p)) % spread
            maxb = 2
        else:
            idx = lane_of * cap + rng.integers(0, cap, (c, p))
        stored = rng.integers(0, p + 1, c)
    else:
        c, p = (256, 8) if name == "none-stored" else (0, 8)
        idx = rng.integers(0, 256, (c, p))
        stored = np.zeros(c, np.int64)
    stride = -(-cap // 128) * 128 if lanes > 1 else 0
    n_pad = lanes * stride if lanes > 1 else max(128, -(-c // 128) * 128)
    act = _t(rng.random(n_pad) < 0.8)
    stored = stored.astype(np.int32)
    pairs = tgrid.PairList(
        idx=_t(idx.astype(np.int32)), run_off=_t(_run_off_of(stored, rng)),
        count=_t(stored),
        demand=torch.tensor(int(stored.max(initial=0)), dtype=torch.int32))
    return pairs, act, n_pad, maxb, lanes, cap


@pytest.mark.parametrize("name", PAIRS_MAP_CASES)
def test_pairs_map_cases_reach_every_branch(name):
    """Each card case below reaches what it is named for: row blocks past
    the pairs column map's staging, spans wider than its bitmap window
    (one with row blocks past the staging, so each window stages its
    chunks again), one lane's overflow alone; and the plain version maps
    a list of no rows to nothing."""
    from repro_torch.core.lanes import Lanes
    k = tbuild.constants("pair_cols")
    pairs, act, n_pad, maxb, lanes, cap = _pairs_map_case(name)
    stored = pairs.run_off[:, 9].numpy().astype(np.int64)
    ln = Lanes(lanes, cap) if lanes > 1 else None
    cols, ovf = tops.build_block_cols_from_pairs_plain(pairs, act, n_pad,
                                                       maxb, ln)
    assert cols.shape == (n_pad // 128, maxb)
    rb_of = np.arange(len(stored)) // 128
    per_rb = np.bincount(rb_of, stored, minlength=1)
    # each row block's span of listed column blocks, over every stored
    # entry (active or not: the card cases make most rows active)
    listed = np.arange(pairs.idx.shape[1]) < stored[:, None]
    ids = pairs.idx.numpy() // 128
    span = np.zeros(len(per_rb), np.int64)
    for rb in np.unique(rb_of[stored > 0]):
        sel = ids[rb_of == rb][listed[rb_of == rb]]
        span[rb] = sel.max() - sel.min()
    if name.startswith("full-rows"):
        assert per_rb.max() == 128 * pairs.idx.shape[1]
    if name == "full-rows-128":
        assert per_rb.max() > k["kStageEntries"]
    if name == "wide-span":
        assert span.max() > 4 * k["kWindowBits"]
    if name == "wide-span-full":
        past = (per_rb > k["kStageEntries"]) & (span > 4 * k["kWindowBits"])
        assert past.all() and not bool(ovf.any())
    if name == "overflow-lanes":
        assert ovf.tolist() == [False, True]
    if name in ("none-stored", "no-rows"):
        assert bool((cols == -1).all()) and not bool(ovf.any())


@pytest.mark.cuda
@pytest.mark.parametrize("name", PAIRS_MAP_CASES)
def test_pairs_column_map_kernel_matches_plain_on_every_branch(name):
    """The pairs column-map kernel ≡ its plain version, entry for entry and
    flag for flag (per lane), on each case above at its maxb and at maxb 2
    (overflow); its first design (launch/kernel_variants.py) too. One
    launch a call of the committed kernel."""
    dev = _cuda_or_skip()
    from repro_torch.core.lanes import Lanes
    from repro_torch.launch import kernel_variants
    pairs, act, n_pad, maxb, lanes, cap = _pairs_map_case(name)
    ln = Lanes(lanes, cap) if lanes > 1 else None
    idx, off, dact = pairs.idx.to(dev), pairs.run_off.to(dev), act.to(dev)
    for mb in (maxb, 2):
        want, want_ovf = tops.build_block_cols_from_pairs_plain(
            pairs, act, n_pad, mb, ln)
        kw = dict(row_active=dact, lanes=lanes)
        before = tpaircols.column_map_from_pairs.launches
        runs = {"kernel": tpaircols.column_map_from_pairs(idx, off, n_pad,
                                                          mb, **kw)}
        assert tpaircols.column_map_from_pairs.launches == before + 1
        runs["first design"] = kernel_variants.pair_cols_map(idx, off, n_pad,
                                                             mb, **kw)
        torch.cuda.synchronize()
        for what, (cols, ovf, _, _) in runs.items():
            np.testing.assert_array_equal(
                cols.cpu().numpy(), want.numpy(),
                err_msg=f"{name}, {what}, maxb {mb}")
            assert ovf.cpu().tolist() == want_ovf.tolist(), (name, what, mb)


@pytest.mark.cuda
def test_k1_on_the_pairs_map_equals_k1_on_the_stencil_map():
    """K1 fed the column map from a skin-0 pair list gives the same force
    and nnz, bit for bit, as K1 fed the stencil map: it adds each row's
    pairs in candidate order and no pair outside its band, and the list
    drops only blocks without a listed candidate."""
    dev = _cuda_or_skip()
    from repro_torch.core import engine as eng
    from repro_torch.launch import simulate
    sim, st = simulate.build("epidemiology", 32768, "breakdown",
                             device="cuda")
    cfg, spec = sim.config, sim.spec
    origin = torch.zeros(3, device=dev)
    res = eng.build_env(cfg, spec, st.pool, origin, cfg.cell_size)
    p = res.pool
    pairs = tgrid.build_pairlist(spec, res.grid, p.position, p.alive,
                                 radius=cfg.interaction_radius, max_pairs=64)
    kw = dict(dims=spec.dims, k_rep=cfg.force.k_rep,
              adhesion_band=cfg.force.adhesion_band)
    args = (p.position, p.diameter, p.agent_type, p.alive, p.alive,
            res.grid.starts, res.grid.counts, origin, cfg.cell_size)
    f0, n0, o0 = tops.collision_force_resident(*args, **kw)
    f1, n1, o1 = tops.collision_force_resident(*args, **kw, pairs=pairs)
    torch.cuda.synchronize()
    assert not bool(o0) and not bool(o1)
    assert torch.equal(f0, f1) and torch.equal(n0, n1)


# ---------------------------------------------------------------------------
# K1 on a narrowed pool (DtypePolicy bf16/f16 diameters, int16 types)
# ---------------------------------------------------------------------------

def _narrowed_fig6(aux, device, n=32768):
    """The Fig-6 pool after the engine's resident build, with the diameter
    stored as ``aux`` and the type and force_nnz as int16."""
    import dataclasses as dc
    from repro_torch.core import DtypePolicy, Simulation
    from repro_torch.core import engine as eng
    from repro_torch.launch import simulate
    sim, _ = simulate.build("proliferation", n, "fig6", device=device)
    cfg = dc.replace(sim.config, dtypes=DtypePolicy(aux_float=aux,
                                                    compact_ints=True))
    sim = Simulation(cfg, sim.behaviors, device=device)
    rng = np.random.default_rng(0)
    side = cfg.domain_hi[0]
    pos = rng.uniform(2.0, side - 2.0, (n, 3)).astype(np.float32)
    types = rng.integers(0, 3, n).astype(np.int32)
    st = sim.init_state(pos, diameter=rng.uniform(2.0, 4.0, n).astype(
        np.float32), agent_type=types)
    origin = torch.tensor(cfg.domain_lo, dtype=torch.float32, device=device)
    res = eng.build_env(cfg, sim.spec, st.pool, origin, cfg.cell_size)
    return sim, res, origin


def _k1_args(sim, res, origin, pool=None):
    p = pool or res.pool
    return (p.position, p.diameter, p.agent_type, p.alive, p.alive,
            res.grid.starts, res.grid.counts, origin, sim.config.cell_size)


@pytest.mark.parametrize("aux", ["bfloat16", "float16"])
def test_k1_inputs_on_a_narrowed_pool_equal_the_float32_pool(aux):
    """The pack casts the narrowed channels exactly: K1's inputs from a
    bf16/f16/int16 pool equal those from the same values in float32 and
    int32, and so do K1's plain force and nnz."""
    sim, res, origin = _narrowed_fig6(aux, "cpu", n=4096)
    p = res.pool
    assert p.diameter.dtype == getattr(torch, aux)
    assert p.agent_type.dtype == torch.int16
    wide = dataclasses.replace(p, diameter=p.diameter.float(),
                               agent_type=p.agent_type.int())
    got = tops.k1_inputs_plain(*_k1_args(sim, res, origin), sim.spec.dims)
    want = tops.k1_inputs_plain(*_k1_args(sim, res, origin, wide),
                                sim.spec.dims)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    kw = dict(dims=sim.spec.dims, k_rep=sim.config.force.k_rep,
              adhesion_band=sim.config.force.adhesion_band)
    f, nnz, _ = tops.collision_force_resident(*_k1_args(sim, res, origin),
                                              **kw)
    fw, nw, _ = tops.collision_force_resident(
        *_k1_args(sim, res, origin, wide), **kw)
    assert nnz.dtype == torch.int32
    assert torch.equal(f, fw) and torch.equal(nnz, nw)


@pytest.mark.cuda
@pytest.mark.parametrize("aux", ["bfloat16", "float16"])
def test_k1_cuda_kernel_on_a_narrowed_pool_matches_plain(aux):
    """The column map and pack ≡ their plain versions entry for entry on a
    bf16/f16 diameter, int16 type pool; K1 ≡ its plain version (force atol
    1e-4, nnz exact); one engine step keeps force_nnz int16."""
    dev = _cuda_or_skip()
    sim, res, origin = _narrowed_fig6(aux, "cuda")
    args = _k1_args(sim, res, origin)
    got = tops.k1_inputs(*args, sim.spec.dims)
    want = tops.k1_inputs_plain(*args, sim.spec.dims)
    torch.cuda.synchronize()
    for g, w, what in zip(got, want, ("data_t", "block_cols", "overflow",
                                      "row mask")):
        assert g.dtype == w.dtype and torch.equal(g, w), what
    kw = dict(dims=sim.spec.dims, k_rep=sim.config.force.k_rep,
              adhesion_band=sim.config.force.adhesion_band)
    f, nnz, ovf = tops.collision_force_resident(*args, **kw)
    cpu = [a.cpu() if isinstance(a, torch.Tensor) else a for a in args]
    fp, np_, op = tops.collision_force_resident(*cpu, **kw)
    assert bool(ovf.cpu()) == bool(op)
    np.testing.assert_allclose(f.cpu().numpy(), fp.numpy(), atol=1e-4)
    assert torch.equal(nnz.cpu(), np_)
    st = sim.step(sim.init_state(res.pool.position[:100].cpu().numpy()))
    torch.cuda.synchronize()
    assert st.pool.force_nnz.dtype == torch.int16
    assert st.pool.diameter.dtype == getattr(torch, aux)
    assert dev.type == "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("force_impl", ["k1", "streamed"])
def test_ladder_grow_on_the_card_equals_presized(force_impl):
    """On the card, a ladder run across capacity, max_per_run and
    max_pairs rungs equals, bit for bit, a run pre-sized at its final
    rungs (tests/test_ladder.py's and tests/test_pairlist.py's
    set-ups)."""
    _cuda_or_skip()
    from repro_torch.core import (CapacityLadder, EngineConfig, ForceParams,
                                  LadderConfig, PairListConfig, Simulation)
    from repro_torch.core.behaviors import (INFECTED, GrowDivide, Infection,
                                            RandomDeath, RandomWalk)

    def live(st):
        a = st.pool.alive.cpu().numpy()
        p = st.pool.position.cpu().numpy()[a]
        o = np.lexsort(p.T)
        return (p[o], st.pool.diameter.cpu().numpy()[a][o],
                st.pool.agent_type.cpu().numpy()[a][o])

    def same(a, b, what):
        for x, y in zip(live(a), live(b)):
            np.testing.assert_array_equal(x, y, err_msg=what)

    fp = ForceParams(max_displacement=0.5)
    # capacity rungs (tests/test_ladder.py)
    rng = np.random.default_rng(0)
    pos, dia = rng.uniform(4, 92, (64, 3)).astype(np.float32), \
        np.full(64, 5.2, np.float32)
    beh = lambda: [GrowDivide(rate=0.8, threshold_diameter=6.0),
                   RandomWalk(sigma=0.3), RandomDeath(rate=0.01)]
    cfg = EngineConfig(capacity=96, domain_lo=(0, 0, 0),
                       domain_hi=(96.0,) * 3, interaction_radius=4.0,
                       dt=1.0, max_per_box=4, query_chunk=256, force=fp,
                       force_impl=force_impl)
    lad = CapacityLadder(cfg, beh(), LadderConfig(round_to=32),
                         device="cuda")
    st = lad.run(lad.init_state(pos, diameter=dia), 9)
    assert {r["field"] for r in lad.rungs} >= {"capacity"}
    sim = Simulation(lad.config, beh(), device="cuda")
    same(st, sim.run(sim.init_state(pos, diameter=dia), 9,
                     check_overflow=True), "capacity rungs")
    # a max_per_run rung
    rng = np.random.default_rng(3)
    pos, dia = rng.uniform(1, 23, (256, 3)).astype(np.float32), \
        np.full(256, 3.0, np.float32)
    cfg = EngineConfig(capacity=1024, domain_lo=(0, 0, 0),
                       domain_hi=(24.0,) * 3, interaction_radius=4.0, dt=0.5,
                       max_per_box=3, query_chunk=128, force=fp,
                       force_impl=force_impl)
    gd = lambda: [GrowDivide(rate=0.5, threshold_diameter=5.0)]
    lad = CapacityLadder(cfg, gd(), device="cuda")
    st = lad.run(lad.init_state(pos, diameter=dia), 5)
    assert any(r["field"] == "max_per_run" for r in lad.rungs), lad.rungs
    sim = Simulation(lad.config, gd(), device="cuda")
    sp = sim.run(sim.init_state(pos, diameter=dia), 5, check_overflow=True)
    same(st, sp, "max_per_run rung")
    assert torch.equal(st.pool.force_nnz, sp.pool.force_nnz)
    # a max_pairs rung (tests/test_pairlist.py)
    n = 900
    pos = np.random.default_rng(4).uniform(2, 46, (n, 3)).astype(np.float32)

    def pl_cfg(max_pairs):
        return EngineConfig(capacity=n, domain_lo=(0, 0, 0),
                            domain_hi=(48.0,) * 3, interaction_radius=3.0,
                            max_per_box=32, query_chunk=256,
                            force_impl=force_impl,
                            pairlist=PairListConfig(skin=0.0,
                                                    max_pairs=max_pairs))

    def sir(s):
        types = np.zeros(n, np.int32)
        types[: n // 20] = INFECTED
        return s.init_state(pos, diameter=np.full(n, 2.5, np.float32),
                            agent_type=types,
                            extra_init={"infect_timer":
                                        np.full(n, 8, np.int32)})
    inf = lambda: [Infection(radius=3.0, beta=0.4, recovery_time=8)]
    lad = CapacityLadder(pl_cfg(2), inf(), device="cuda")
    st = lad.run(sir(lad), 4)
    assert any(r["field"] == "max_pairs" for r in lad.rungs), lad.rungs
    pre = Simulation(pl_cfg(lad.config.pairlist.max_pairs), inf(),
                     device="cuda")
    sp = pre.run(sir(pre), 4, check_overflow=True)
    for ch in ("position", "agent_type", "force_nnz"):
        assert torch.equal(getattr(st.pool, ch), getattr(sp.pool, ch)), ch
