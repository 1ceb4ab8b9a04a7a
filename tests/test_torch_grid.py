"""Port grid build and commit phase ≡ the reference, exactly.

The reference engine runs its build jitted with the origin and box size as
constants of the program (engine.make_iteration_core), so the JAX side here
is jitted the same way: that is where ``cell_of``'s division becomes a
multiply by the float32 reciprocal.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import agents as jagents  # noqa: E402
from repro.core import compaction as jcomp, grid as jgrid  # noqa: E402
from repro.core import morton as jmorton  # noqa: E402
from repro_torch.core import agents as tagents  # noqa: E402
from repro_torch.core import compaction as tcomp, grid as tgrid  # noqa: E402
from repro_torch.core import morton as tmorton  # noqa: E402


@pytest.fixture(autouse=True)
def _single_thread():
    """torch's multi-threaded CPU kernels were seen to return a whole
    worker's chunk of float32 sqrt results off by ~3e-4 (relative) on some
    hosts; one thread keeps the parity tests deterministic."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _pools(pos, c, alive=None, dia=None):
    n = len(pos)
    dia = np.full(n, 1.0, np.float32) if dia is None else dia
    jp = jagents.make_pool(c, position=jnp.asarray(pos),
                           diameter=jnp.asarray(dia))
    tp = tagents.make_pool(c, position=pos, diameter=dia, device="cpu")
    if alive is not None:
        jp = dataclasses.replace(jp, alive=jnp.asarray(alive))
        tp = dataclasses.replace(tp, alive=torch.from_numpy(alive.copy()))
    return jp, tp


def _assert_pools_equal(jp, tp):
    jc, tc = jp.channels(), tp.channels()
    assert set(jc) == set(tc)
    for k in jc:
        want = np.asarray(jc[k])
        got = tc[k].numpy()
        assert got.dtype == want.dtype, k
        np.testing.assert_array_equal(got, want, err_msg=k)


def _builds(spec, jp, tp, box):
    origin = jnp.zeros(3, jnp.float32)
    box_c = jnp.asarray(box, jnp.float32)
    jbuild = jax.jit(lambda p: jgrid._build_resident_impl(spec, p, origin,
                                                          box_c))
    return jbuild(jp), tgrid._build_resident_impl(spec, tp, torch.zeros(3),
                                                  box)


@pytest.mark.parametrize("n,c,dims,box,dead", [
    (200, 256, (10, 10, 10), 2.0, 0.0),
    (333, 400, (7, 9, 11), 3.0, 0.2),
    (1000, 40000, (12, 12, 12), 1.7, 0.1),     # capacity ≥ 2^15: int32 counts
])
def test_resident_build_matches_jitted_reference(rng, n, c, dims, box, dead):
    pos = rng.uniform(0, min(dims) * box, (n, 3)).astype(np.float32)
    alive = np.zeros(c, bool)
    alive[:n] = rng.random(n) >= dead
    jp, tp = _pools(pos, c, alive)
    spec = jgrid.GridSpec(dims=dims)
    tspec = tgrid.GridSpec(dims=dims)
    (jpool, jg, jorder), (tpool, tg, torder) = _builds(spec, jp, tp, box)
    keys = tmorton.grid_sort_keys(tp.position, tp.alive, torch.zeros(3), box,
                                  dims)
    jkeys = jax.jit(lambda p, a: jmorton.grid_sort_keys(
        p, a, jnp.zeros(3), jnp.float32(box), dims))(jp.position, jp.alive)
    np.testing.assert_array_equal(keys.numpy(),
                                  np.asarray(jkeys).astype(np.int64))
    np.testing.assert_array_equal(torder.numpy(), np.asarray(jorder))
    _assert_pools_equal(jpool, tpool)
    for f in ("starts", "counts", "max_count", "max_run_count"):
        want = np.asarray(getattr(jg, f))
        got = getattr(tg, f).numpy()
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    np.testing.assert_array_equal(tg.keys.numpy(),
                                  np.asarray(jg.keys).astype(np.int64))
    res = tgrid.make_builder(tspec)(tp, torch.zeros(3), box)
    assert int(res.demand) == int(jg.max_run_count)
    assert int(res.overflow) == max(int(jg.max_run_count)
                                    - spec.run_capacity, 0)


def _boundary_coords(box, n_boxes):
    """float32 coordinates just below k·box where p/box and p·(1/box) floor
    to different cells."""
    b = np.float32(box)
    r = np.float32(1.0) / b
    out = []
    for k in range(1, n_boxes):
        p = np.array([k * b], np.float32)
        for _ in range(64):
            p = np.nextafter(p, np.float32(0))
            if np.floor(p[0] / b) != np.floor(p[0] * r):
                out.append(p[0])
    return np.array(out, np.float32)


def test_cell_of_uses_the_jitted_engines_reciprocal(rng):
    """Positions where division and reciprocal multiply floor differently:
    the port follows the jitted reference build, not the true division."""
    box, dims = 14.0, (9, 9, 9)
    coords = _boundary_coords(box, dims[0])
    assert len(coords) >= 3
    m = len(coords)
    pos = rng.uniform(0, 120, (3 * m, 3)).astype(np.float32)
    for axis in range(3):
        pos[axis * m:(axis + 1) * m, axis] = coords
    jp, tp = _pools(pos, 3 * m + 5)
    spec = jgrid.GridSpec(dims=dims)
    (jpool, jg, jorder), (tpool, tg, torder) = _builds(spec, jp, tp, box)
    true_div = np.floor(coords / np.float32(box)).astype(np.int32)
    port_cells = tmorton.cell_of(torch.from_numpy(pos), torch.zeros(3), box,
                                 dims).numpy()
    for axis in range(3):
        assert (port_cells[axis * m:(axis + 1) * m, axis] != true_div).all()
    np.testing.assert_array_equal(torder.numpy(), np.asarray(jorder))
    np.testing.assert_array_equal(tg.keys.numpy(),
                                  np.asarray(jg.keys).astype(np.int64))
    np.testing.assert_array_equal(tg.counts.numpy(), np.asarray(jg.counts))


@pytest.mark.parametrize("c,p_alive", [(64, 0.5), (200, 0.9), (37, 0.0)])
def test_compact_matches_reference(rng, c, p_alive):
    pos = rng.uniform(0, 10, (c, 3)).astype(np.float32)
    alive = rng.random(c) < p_alive
    jp, tp = _pools(pos, c, alive)
    perm_t, n_t = tcomp.compaction_permutation(tp.alive)
    perm_j, n_j = jcomp.compaction_permutation(jp.alive)
    np.testing.assert_array_equal(perm_t.numpy(), np.asarray(perm_j))
    assert int(n_t) == int(n_j)
    _assert_pools_equal(jcomp.compact(jp), tcomp.compact(tp))


@pytest.mark.parametrize("c,n_live,q,p_valid", [
    (128, 40, 64, 0.5),        # fits
    (64, 50, 64, 0.6),         # overflows: writes parked at c and dropped
    (32, 32, 16, 1.0),         # full pool: every newborn dropped
])
def test_commit_births_matches_reference(rng, c, n_live, q, p_valid):
    pos = rng.uniform(0, 10, (n_live, 3)).astype(np.float32)
    jp, tp = _pools(pos, c)
    valid = rng.random(q) < p_valid
    qpos = rng.uniform(0, 10, (q, 3)).astype(np.float32)
    qdia = rng.uniform(1, 2, q).astype(np.float32)
    qtyp = rng.integers(0, 3, q).astype(np.int32)
    jq = {"position": jnp.asarray(qpos), "diameter": jnp.asarray(qdia),
          "agent_type": jnp.asarray(qtyp)}
    tq = {"position": torch.from_numpy(qpos),
          "diameter": torch.from_numpy(qdia),
          "agent_type": torch.from_numpy(qtyp)}
    it = 17
    jout = jcomp.commit_births(jp, jq, jnp.asarray(valid), jnp.int32(it))
    tout = tcomp.commit_births(tp, tq, torch.from_numpy(valid),
                               torch.tensor(it, dtype=torch.int32))
    _assert_pools_equal(jout, tout)
    assert int(tcomp.birth_overflow(tp, torch.from_numpy(valid))) == \
        int(jcomp.birth_overflow(jp, jnp.asarray(valid)))
