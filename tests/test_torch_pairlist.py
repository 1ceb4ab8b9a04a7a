"""Port Verlet pair list ≡ the reference's (``repro.core.grid`` PairList).

The pool is built by the reference's resident builder and carried into the
port, so both sides list the same layout. The list itself (idx, run_off,
count, demand) must be equal entry for entry, overflow included; the
pair-list sweep's integer outputs equal, floats within 1e-5 (DESIGN.md
§3.4 "Exactness, precisely": the two packages' lane sums group
differently); the column map from the list equal, flag included. On the
port's own side, skin 0 reproduces the streamed sweep's integers and K1's
sums on the stencil map.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from hypothesis_compat import given, settings, st  # noqa: E402
from repro.core import EngineConfig as JConfig  # noqa: E402
from repro.core import engine as jeng, grid as jgrid  # noqa: E402
from repro.core.behaviors import INFECTED  # noqa: E402
from repro.core.behaviors import Infection as JInfection  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.core import EngineConfig as TConfig  # noqa: E402
from repro_torch.core import Simulation as TSim  # noqa: E402
from repro_torch.core import engine as teng, grid as tgrid  # noqa: E402
from repro_torch.core.agents import pool_from_channels  # noqa: E402
from repro_torch.core.behaviors import Infection as TInfection  # noqa: E402
from repro_torch.kernels import collision_force as tk1  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402

SIDE = 24.0
FLOAT_TOL = 1e-5


@pytest.fixture(autouse=True)
def _single_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _kw(cap, radius=3.0, chunk=64, max_per_box=16):
    return dict(capacity=cap, domain_lo=(0, 0, 0), domain_hi=(SIDE,) * 3,
                interaction_radius=radius, max_per_box=max_per_box,
                query_chunk=chunk)


def _built(n=300, cap=None, skin=0.0, seed=0, max_per_box=16, dead=0.1,
           pos=None):
    """A reference resident build of a random pool (some dead slots, 5%
    infected) and its port twin: (jax spec, port spec, jax grid, jax
    channels, port grid, port channels)."""
    rng = np.random.default_rng(seed)
    cap = cap or n + 84
    pol = (dict(rebuild=jgrid.RebuildPolicy("every_k", 4, skin / 2))
           if skin else {})
    jcfg = JConfig(**_kw(cap, max_per_box=max_per_box), **pol)
    tcfg = TConfig(**_kw(cap, max_per_box=max_per_box),
                   **({"rebuild": tgrid.RebuildPolicy("every_k", 4, skin / 2)}
                      if skin else {}))
    sim = jeng.Simulation(jcfg, [JInfection(radius=3.0)])
    if pos is None:
        pos = rng.uniform(0.5, SIDE - 0.5, (n, 3)).astype(np.float32)
    n = pos.shape[0]
    types = (rng.random(n) < 0.05).astype(np.int32) * INFECTED
    s = sim.init_state(pos, diameter=rng.uniform(1.5, 2.6, n).astype(
        np.float32), agent_type=types)
    alive = np.asarray(s.pool.alive).copy()
    alive[rng.choice(n, int(n * dead), replace=False)] = False
    s.pool.alive = jnp.asarray(alive)
    spec = jcfg.grid_spec
    build = jgrid.make_builder(spec, method="resident")
    res = jax.jit(lambda p: build(p, jnp.zeros(3, jnp.float32),
                                  jnp.float32(jcfg.cell_size)))(s.pool)
    jch = res.pool.channels()
    tch = {k: torch.from_numpy(np.asarray(v).copy()) for k, v in jch.items()}
    tres = tgrid.make_builder(tcfg.grid_spec)(pool_from_channels(tch),
                                              torch.zeros(3), tcfg.cell_size)
    return spec, tcfg.grid_spec, res.grid, jch, tres.grid, tch


def _jpairs(spec, jg, jch, radius, max_pairs, chunk=64):
    return jax.jit(lambda g, p, a: jgrid.build_pairlist(
        spec, g, p, a, radius=radius, max_pairs=max_pairs, chunk=chunk))(
            jg, jch["position"], jch["alive"])


def _assert_pairs_equal(want, got):
    for f in ("idx", "run_off", "count", "demand"):
        g = getattr(got, f)
        assert g.dtype == torch.int32, f
        np.testing.assert_array_equal(g.numpy(), np.asarray(getattr(want, f)),
                                      err_msg=f)


def _to_torch_pairs(p):
    return tgrid.PairList(*(torch.from_numpy(np.asarray(x).copy())
                            for x in (p.idx, p.run_off, p.count, p.demand)))


def test_pairlist_config_validation():
    for bad in (dict(skin=-0.1), dict(max_pairs=0), dict(max_pairs=2.0)):
        with pytest.raises(ValueError):
            jgrid.PairListConfig(**bad)
        with pytest.raises(ValueError):
            tgrid.PairListConfig(**bad)
    kw = _kw(64)
    for change in (dict(pairlist=dict(skin=0.5, max_pairs=8)),
                   dict(fused_sweep=False, pairlist=dict(max_pairs=8)),
                   dict(detect_static=True, pairlist=dict(max_pairs=8))):
        pl = change.pop("pairlist")
        with pytest.raises(ValueError):
            JConfig(**kw, **change, pairlist=jgrid.PairListConfig(**pl))
        with pytest.raises(ValueError):
            TConfig(**kw, **change, pairlist=tgrid.PairListConfig(**pl))
    j = JConfig(**kw, rebuild=jgrid.RebuildPolicy("every_k", 4, 0.2),
                pairlist=jgrid.PairListConfig(skin=0.9, max_pairs=8))
    t = TConfig(**kw, rebuild=tgrid.RebuildPolicy("every_k", 4, 0.2),
                pairlist=tgrid.PairListConfig(skin=0.9, max_pairs=8))
    assert t.cell_size == j.cell_size == pytest.approx(3.9)
    assert t.grid_spec.dims == j.grid_spec.dims


def test_grow_pairlist_padding():
    p = tgrid.initial_pairlist(4, 3)
    p = dataclasses.replace(p, idx=torch.arange(12, dtype=torch.int32
                                                ).reshape(4, 3),
                            count=torch.tensor([3, 1, 0, 2],
                                               dtype=torch.int32))
    g = tgrid.grow_pairlist(p, 6, 5)
    jp = jgrid.grow_pairlist(jgrid.PairList(
        idx=jnp.arange(12, dtype=jnp.int32).reshape(4, 3),
        run_off=jnp.zeros((4, 10), jnp.int32),
        count=jnp.array([3, 1, 0, 2], jnp.int32),
        demand=jnp.zeros((), jnp.int32)), 6, 5)
    _assert_pairs_equal(jp, g)
    assert tgrid.grow_pairlist(p, 4, 3) is p
    with pytest.raises(ValueError):
        tgrid.grow_pairlist(p, 2, 5)


def test_rebuild_state_and_grow_grid_state_match_reference():
    spec = tgrid.GridSpec(dims=(3, 4, 5), max_per_box=8)
    jspec = jgrid.GridSpec(dims=(3, 4, 5), max_per_box=8)
    for cap, new_cap in ((100, 300), (30000, 40000)):    # int16 → int32
        pl = tgrid.PairListConfig(skin=0.5, max_pairs=6)
        t = tgrid.initial_rebuild_state(spec, cap, torch.zeros(3), 2.5, pl)
        j = jgrid.initial_rebuild_state(
            jspec, cap, jnp.zeros(3), 2.5,
            jgrid.PairListConfig(skin=0.5, max_pairs=6))
        for f in ("keys", "order", "rank", "starts", "counts", "max_count",
                  "max_run_count"):
            w, g = np.asarray(getattr(j.grid, f)), getattr(t.grid, f)
            np.testing.assert_array_equal(g.numpy(), w, err_msg=f)
            if f != "keys":
                assert g.numpy().dtype == w.dtype, f
        assert bool(t.dirty) and int(t.steps_since) == 0
        assert t.pairs.idx.shape == (cap, 6) and float(t.pair_disp) == 0.0
        gj = jgrid.grow_grid_state(j.grid, new_cap)
        gt = tgrid.grow_grid_state(t.grid, new_cap)
        for f in ("keys", "order", "rank", "counts", "max_count",
                  "max_run_count"):
            w, g = np.asarray(getattr(gj, f)), getattr(gt, f)
            np.testing.assert_array_equal(g.numpy(), w, err_msg=f)
            if f != "keys":
                assert g.numpy().dtype == w.dtype, f
    assert tgrid.grow_grid_state(t.grid, 30000 + 10000) is not t.grid
    with pytest.raises(ValueError):
        tgrid.grow_grid_state(t.grid, 10)


@pytest.mark.parametrize("case", [
    dict(n=300, skin=0.0, max_pairs=32),
    dict(n=300, skin=0.0, max_pairs=4),             # overflow rows
    dict(n=500, skin=1.2, max_pairs=64, dead=0.3),
    dict(n=120, skin=0.6, max_pairs=16, max_per_box=3),   # runs truncated
])
@pytest.mark.parametrize("chunk", [64, 7])
def test_build_pairlist_matches_reference(case, chunk):
    case = dict(case)
    skin, mp = case.pop("skin"), case.pop("max_pairs")
    spec, tspec, jg, jch, tg, tch = _built(skin=skin, **case)
    want = _jpairs(spec, jg, jch, 3.0 + skin, mp)
    got = tgrid.build_pairlist(tspec, tg, tch["position"], tch["alive"],
                               radius=3.0 + skin, max_pairs=mp, chunk=chunk)
    _assert_pairs_equal(want, got)
    dead = ~tch["alive"]
    assert not got.count[dead].any() and not got.idx[dead].any()
    if mp == 4:
        assert int(got.demand) > 4


@pytest.mark.parametrize("max_pairs", [64, 4])
@pytest.mark.parametrize("chunk", [64, 7])
def test_build_pairlist_on_a_permuted_pool_matches_reference(max_pairs,
                                                            chunk):
    """Rows out of grid order (the pool's rows permuted, the tables kept,
    so runs name slots whose agents lie elsewhere): the port's plain list
    ≡ the reference's build_pairlist on the same arrays, entry for entry —
    the function the card kernel's global branch is held to."""
    spec, tspec, jg, jch, tg, tch = _built(n=500, skin=1.2, dead=0.3)
    perm = np.random.default_rng(5).permutation(len(tch["position"]))
    jch = dict(jch, position=jnp.asarray(np.asarray(jch["position"])[perm]),
               alive=jnp.asarray(np.asarray(jch["alive"])[perm]))
    tpos, talive = tch["position"][perm], tch["alive"][perm]
    want = _jpairs(spec, jg, jch, 4.2, max_pairs)
    got = tgrid.build_pairlist(tspec, tg, tpos, talive, radius=4.2,
                               max_pairs=max_pairs, chunk=chunk)
    _assert_pairs_equal(want, got)
    assert int(got.count.sum()) > 0
    if max_pairs == 4:
        assert int(got.demand) > 4


@pytest.mark.parametrize("skin", [0.0, 1.0])
def test_pair_sweep_matches_reference_pairs_mode(skin):
    """Force and Infection kernels over the pair list: integers exact,
    floats within 1e-5 of the reference's pairs mode."""
    spec, tspec, jg, jch, tg, tch = _built(skin=skin, n=400)
    jpairs = _jpairs(spec, jg, jch, 3.0 + skin, 48)
    tpairs = _to_torch_pairs(jpairs)
    jcfg = JConfig(**_kw(484))
    tcfg = TConfig(**_kw(484))
    jk = jeng.registered_kernels(jcfg, [JInfection(radius=3.0)])
    tk = teng.registered_kernels(tcfg, [TInfection(radius=3.0)], "cpu")
    alive_j, alive_t = jch["alive"], tch["alive"]
    want = jax.jit(lambda g, ch, m, pl: jgrid.resident_apply_fused(
        spec, g, ch, jk, m, 64, pairs=pl))(jg, jch, alive_j, jpairs)
    got = tgrid.resident_apply_fused(tspec, tg, tch, tk, alive_t, 64,
                                     pairs=tpairs)
    for kname, outs in want.items():
        for name, w in outs.items():
            w, g = np.asarray(w), got[kname][name].numpy()
            assert g.dtype == w.dtype, (kname, name)
            if w.dtype.kind == "f":
                np.testing.assert_allclose(g, w, atol=FLOAT_TOL,
                                           rtol=FLOAT_TOL, err_msg=name)
            else:
                np.testing.assert_array_equal(g, w, err_msg=name)


def test_pair_sweep_at_skin_0_equals_the_streamed_sweep():
    """With skin 0 and a list built this step the pair-list sweep's
    integer outputs equal the streamed sweep's, and its floats agree to
    1e-5; chunkings give equal bits."""
    _, tspec, _, _, tg, tch = _built(n=400)
    tk = teng.registered_kernels(TConfig(**_kw(484)),
                                 [TInfection(radius=3.0)], "cpu")
    pairs = tgrid.build_pairlist(tspec, tg, tch["position"], tch["alive"],
                                 radius=3.0, max_pairs=48)
    assert int(pairs.demand) <= 48
    streamed = tgrid.resident_apply_fused(tspec, tg, tch, tk, tch["alive"])
    listed = tgrid.resident_apply_fused(tspec, tg, tch, tk, tch["alive"],
                                        pairs=pairs)
    other = tgrid.resident_apply_fused(tspec, tg, tch, tk, tch["alive"], 5,
                                       pairs=pairs)
    assert int(listed["infection"]["exposed"].sum()) > 0
    for kname, outs in streamed.items():
        for name, s in outs.items():
            got = listed[kname][name]
            assert torch.equal(got, other[kname][name]), name
            if s.dtype.is_floating_point:
                np.testing.assert_allclose(got.numpy(), s.numpy(),
                                           atol=FLOAT_TOL, rtol=FLOAT_TOL)
            else:
                assert torch.equal(got, s), (kname, name)


_DOMAINS = {
    "uniform": lambda rng, n: rng.uniform(2, SIDE - 2, (n, 3)),
    "clustered": lambda rng, n: np.clip(
        rng.uniform(6, SIDE - 6, (3, 3))[rng.integers(0, 3, n)]
        + rng.normal(0, 1.5, (n, 3)), 1.0, SIDE - 1.0),
    "slab": lambda rng, n: np.concatenate(
        [rng.uniform(2, SIDE - 2, (n, 2)), rng.uniform(10, 13, (n, 1))], 1),
}


@settings(max_examples=8, deadline=None)
@given(st.integers(0, 10_000), st.floats(0.2, 1.2),
       st.sampled_from(tuple(_DOMAINS)))
def test_skin_coverage_property(seed, skin, domain):
    """No pair within r at current positions is missing from a list built
    at r + skin while every agent moved at most skin/2 (euclidean)."""
    rng = np.random.default_rng(seed)
    n, r = 200, 3.0
    pos = _DOMAINS[domain](rng, n).astype(np.float32)
    cfg = TConfig(**_kw(n, max_per_box=64),
                  rebuild=tgrid.RebuildPolicy("every_k", 8, skin / 2),
                  pairlist=tgrid.PairListConfig(skin=skin, max_pairs=128))
    pool = teng.stage_pool(n, [], torch.from_numpy(pos), device="cpu")
    res = teng.build_env(cfg, cfg.grid_spec, pool, torch.zeros(3),
                         cfg.cell_size)
    pl = tgrid.build_pairlist(cfg.grid_spec, res.grid, res.pool.position,
                              res.pool.alive, radius=r + skin,
                              max_pairs=128)
    if int(pl.demand) > 128:
        # a dense cluster overflowed the list (flagged, never silent); the
        # coverage property is about a list that holds every candidate, so
        # rebuild it at the demanded width, as the ladder's max_pairs rung
        # would
        pl = tgrid.build_pairlist(cfg.grid_spec, res.grid,
                                  res.pool.position, res.pool.alive,
                                  radius=r + skin,
                                  max_pairs=int(pl.demand))
    assert int(pl.demand) <= pl.idx.shape[1]
    stored = pl.run_off[:, 9].numpy()
    listed = [set(pl.idx[i, :stored[i]].tolist()) for i in range(n)]
    step = rng.normal(size=(n, 3))
    step *= rng.uniform(0, skin / 2, (n, 1)) / np.maximum(
        np.linalg.norm(step, axis=1, keepdims=True), 1e-9)
    p1 = res.pool.position.numpy() + step.astype(np.float32)
    d2 = ((p1[:, None] - p1[None]) ** 2).sum(-1)
    for i, j in zip(*np.nonzero(d2 <= r * r)):
        if i != j:
            assert j in listed[i], (i, j, skin, domain)


@pytest.mark.parametrize("maxb", [64, 1])
def test_block_cols_from_pairs_matches_reference(maxb):
    spec, tspec, jg, jch, tg, tch = _built(n=600, cap=640, skin=0.8)
    jpairs = _jpairs(spec, jg, jch, 3.8, 64)
    rng = np.random.default_rng(3)
    act = np.asarray(jch["alive"]) & (rng.random(640) < 0.7)
    n_pad = 768
    ap = np.zeros(n_pad, bool)
    ap[:640] = act
    want = jax.jit(lambda pl, a: jops.build_block_cols_from_pairs(
        pl, a, n_pad, maxb))(jpairs, jnp.asarray(ap))
    got = tops.build_block_cols_from_pairs(_to_torch_pairs(jpairs),
                                           torch.from_numpy(ap), n_pad, maxb)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    assert bool(got[1]) == bool(want[1]) == (maxb == 1)


def test_k1_plain_on_the_pairs_map_equals_the_stencil_map():
    """K1's plain version fed the skin-0 pair list's map: nnz equal and the
    force within 1e-5 of K1 on the stencil map, on a map no wider than it.
    (The plain version sums a chunk's listed columns in one vectorised
    reduction, whose grouping moves with the columns' positions; the CUDA
    kernel adds in candidate order and is held bit for bit by
    tests/test_torch_kernels.py on the card.)"""
    _, tspec, _, _, tg, tch = _built(n=900, cap=1024)
    cfg = TConfig(**_kw(1024))
    pairs = tgrid.build_pairlist(tspec, tg, tch["position"], tch["alive"],
                                 radius=3.0, max_pairs=64)
    args = (tch["position"], tch["diameter"], tch["agent_type"],
            tch["alive"], tch["alive"], tg.starts, tg.counts,
            torch.zeros(3), cfg.cell_size)
    kw = dict(dims=tspec.dims, k_rep=2.0, adhesion_band=0.4)
    f0, n0, _ = tops.collision_force_resident(*args, **kw)
    f1, n1, _ = tops.collision_force_resident(*args, **kw, pairs=pairs)
    np.testing.assert_allclose(f1.numpy(), f0.numpy(), atol=FLOAT_TOL,
                               rtol=0)
    assert torch.equal(n0, n1) and int(n0.sum()) > 0
    _, c0, _, _ = tops.k1_inputs(*args, tspec.dims)
    _, c1, _, _ = tops.k1_inputs(*args, tspec.dims, pairs=pairs)
    assert int((c1 >= 0).sum()) <= int((c0 >= 0).sum())
    assert tk1.BLOCK == tops.BLOCK


def test_run_raises_on_pair_overflow_like_reference():
    n = 300
    pos = np.random.default_rng(4).uniform(1, SIDE - 1, (n, 3)).astype(
        np.float32)
    kw = dict(**_kw(384), pairlist=None)
    for mp, raises in ((2, True), (64, False)):
        kw["pairlist"] = tgrid.PairListConfig(max_pairs=mp)
        sim = TSim(TConfig(**kw), [TInfection(radius=3.0)], device="cpu")
        st_ = sim.init_state(pos, diameter=np.full(n, 2.0, np.float32))
        if raises:
            with pytest.raises(RuntimeError, match="pair-list overflow"):
                sim.run(st_, 1, check_overflow=True)
        else:
            st_ = sim.run(st_, 2, check_overflow=True)
            assert 0 < int(st_.stats["pair_demand"]) <= mp
            assert int(st_.stats["pair_overflow"]) == 0
