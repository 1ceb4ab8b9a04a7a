"""Port static-region detection ≡ the reference, exactly: box-granular
disturbance over the resident tables, dead slots (DEAD_KEY) included."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import agents as jagents, grid as jgrid  # noqa: E402
from repro.core import statics as jstatics  # noqa: E402
from repro_torch.core import agents as tagents, grid as tgrid  # noqa: E402
from repro_torch.core import statics as tstatics  # noqa: E402


def _pools(rng, n, c, side, p_moved, p_dead):
    pos = rng.uniform(0, side, (n, 3)).astype(np.float32)
    jp = jagents.make_pool(c, position=jnp.asarray(pos))
    tp = tagents.make_pool(c, position=pos, device="cpu")
    alive = np.arange(c) < n
    alive[rng.random(c) < p_dead] = False
    fields = dict(
        alive=alive, moved=rng.random(c) < p_moved,
        grew=rng.random(c) < p_moved / 4,
        born_iter=rng.integers(0, 6, c).astype(np.int32),
        force_nnz=rng.integers(0, 3, c).astype(np.int32))
    jp = dataclasses.replace(jp, **{k: jnp.asarray(v)
                                    for k, v in fields.items()})
    tp = dataclasses.replace(tp, **{k: torch.from_numpy(v.copy())
                                    for k, v in fields.items()})
    return jp, tp


@pytest.mark.parametrize("n,c,side,p_moved,p_dead", [
    (400, 512, 30.0, 0.02, 0.1),
    (400, 512, 30.0, 0.3, 0.0),
    (300, 300, 12.0, 0.01, 0.5),      # dense, half dead
    (0, 64, 10.0, 0.5, 0.0),          # nobody alive
])
def test_static_flags_match_reference(rng, n, c, side, p_moved, p_dead):
    jp, tp = _pools(rng, n, c, side, p_moved, p_dead)
    dims = (int(np.ceil(side / 3.0)),) * 3
    spec = jgrid.GridSpec(dims=dims)
    tspec = tgrid.GridSpec(dims=dims)
    jb = jgrid.make_builder(spec, method="resident")
    jres = jax.jit(lambda p: jb(p, jnp.zeros(3), jnp.float32(3.0)))(jp)
    tres = tgrid.make_builder(tspec)(tp, torch.zeros(3), 3.0)
    it = 5
    want_nbh = jax.jit(lambda p, g: jstatics.neighborhood_disturbed(
        spec, g, p, jnp.int32(it)))(jres.pool, jres.grid)
    got_nbh = tstatics.neighborhood_disturbed(tspec, tres.grid, tres.pool,
                                              torch.tensor(it))
    np.testing.assert_array_equal(got_nbh.numpy(), np.asarray(want_nbh))
    want = jax.jit(lambda p, g: jstatics.update_static_flags(
        p, spec, g, jnp.int32(it)))(jres.pool, jres.grid)
    got = tstatics.update_static_flags(tres.pool, tspec, tres.grid,
                                       torch.tensor(it))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if n and p_moved < 0.05:
        assert got.any() and not got.all()


def test_dead_keys_never_disturb_a_box():
    """A dead slot that moved must not mark the last box (its key is
    2**32 - 1, clamped to the dropped row m)."""
    c = 16
    tp = tagents.make_pool(c, position=np.full((4, 3), 1.0, np.float32),
                           device="cpu")
    tp = dataclasses.replace(tp, moved=torch.zeros(c, dtype=torch.bool))
    tp.moved[4:] = True                    # only dead slots moved
    spec = tgrid.GridSpec(dims=(3, 3, 3))
    res = tgrid.make_builder(spec)(tp, torch.zeros(3), 3.0)
    assert int(res.grid.keys[-1]) == 2 ** 32 - 1
    assert not tstatics.neighborhood_disturbed(
        spec, res.grid, res.pool, torch.tensor(1)).any()
