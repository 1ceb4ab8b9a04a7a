"""K1 in the port ≡ the reference's K1 (Pallas, interpret mode) and oracle.

Column maps and overflow flags must match exactly, nnz exactly, forces to
atol 1e-4 (the tolerance tests/test_kernels.py holds Pallas K1 to). On the
CPU the port's wrapper runs K1's plain version; the CUDA kernel itself is
held against that plain version by the card-only tests at the end, which
need no JAX (the GPU host runs them with
``python -m pytest -q tests/test_torch_kernels.py -m cuda``).
"""

import types

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
