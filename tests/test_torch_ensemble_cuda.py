"""The ensemble on the card: lanes ≡ their solo runs, one K1 launch a tick.

Card-only (``cuda`` marker; they skip without a CUDA device and import no
JAX, so the GPU host runs them with ``python -m pytest -q
tests/test_torch_ensemble_cuda.py -m cuda``). Lanes of 96 agents in
capacity 192 (not a multiple of 128, so K1's packing pads each lane to
whole row blocks): the lane-aware column map kernel ≡ its plain version
entry for entry, with per-lane overflow flags; every lane of an SIR and
of a K1 ensemble ≡ its solo run on the card bit for bit, RNG keys
included; K1 and the column map launch once a tick for all lanes.

Tissue lanes (every_k, pair lists, diffusion): the lane-aware pair-list
and pairs column-map kernels ≡ their plain versions entry for entry
(per-lane demands and flags too), secretion over lane-offset voxels ≡ the
CPU bit for bit, and clustering lanes with K1 over their pair lists ≡
their solo card runs, the build, the map, K1 and secretion once a tick.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import (DiffusionSpec, EngineConfig,  # noqa: E402
                              EnsembleEngine, ForceParams, PairListConfig,
                              RebuildPolicy, ScenarioParams, Simulation,
                              build_env, make_iteration_core)
from repro_torch.core import behaviors as tb  # noqa: E402
from repro_torch.core import diffusion as tdiff  # noqa: E402
from repro_torch.core import grid as tgrid  # noqa: E402
from repro_torch.core.lanes import Lanes  # noqa: E402
from repro_torch.kernels import block_cols as colmap  # noqa: E402
from repro_torch.kernels import collision_force as tk1  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import pair_cols, pairlist, secretion  # noqa: E402

N, CAP, LANES = 96, 192, 3


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _cfg(**over):
    kw = dict(capacity=CAP, domain_lo=(0.0,) * 3, domain_hi=(30.0,) * 3,
              interaction_radius=3.0, use_forces=False, detect_static=False,
              query_chunk=1024, max_per_box=32)
    kw.update(over)
    return EngineConfig(**kw)


def _inputs(seed):
    r = np.random.RandomState(seed)
    pos = r.uniform(0, 30, (N, 3)).astype(np.float32)
    at = np.zeros((N,), np.int32)
    at[:8] = tb.INFECTED
    timer = np.zeros((N,), np.int32)
    timer[:8] = 40
    return pos, np.full((N,), 2.5, np.float32), at, {"infect_timer": timer}


def _sir():
    return [tb.RandomWalk(sigma=0.8),
            tb.Infection(radius=3.0, beta=lambda ctx: ctx.params["beta"],
                         recovery_time=40)]


@pytest.mark.cuda
@pytest.mark.parametrize("maxb,span", [(64, 8), (2, 8), (64, 1)])
def test_lane_column_map_kernel_equals_plain(maxb, span):
    dev = _card()
    cfg = _cfg(use_forces=True)
    eng = EnsembleEngine(cfg, [], LANES, device=dev)
    st = eng.init_state()
    for lane in range(LANES):
        st = eng.admit(st, lane, eng.stage_lane(*_inputs(lane)[:2],
                                                seed=lane))
    ln = Lanes(LANES, CAP)
    origin = torch.zeros(3, device=dev)
    res = build_env(cfg, cfg.grid_spec, st.pool, origin, cfg.cell_size, ln)
    pool, g = res.pool, res.grid
    active = pool.alive.clone()
    active[CAP:CAP + 40] = False                 # part of lane 1 inactive
    args = (pool.position, pool.diameter, pool.agent_type, pool.alive,
            active, g.starts, g.counts, origin, cfg.cell_size,
            cfg.grid_spec.dims, maxb, None, ln)
    colmap.column_map.launches = 0
    got = tops.k1_inputs(*args)
    want = tops.k1_inputs_plain(*args)
    assert colmap.column_map.launches == 1
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b.to(a.device))
    assert got[0].shape[1] == LANES * 256 and got[2].shape == (LANES,)
    # each row block lists column blocks of its own lane only
    rb_lane = torch.arange(got[1].shape[0], device=dev) // 2
    cols = got[1]
    assert bool(((cols < 0) | (cols // 2 == rb_lane[:, None])).all())
    if span == 8 and maxb == 64:
        out = tk1.collision_force(got[0], got[1], k_rep=2.0, adhesion=None,
                                  adhesion_band=0.4)
        plain = tk1.collision_force_plain(got[0], got[1], k_rep=2.0,
                                          adhesion=None, adhesion_band=0.4)
        assert float((out[:3] - plain[:3]).abs().max()) <= 1e-4
        assert torch.equal(out[3], plain[3]) and int(out[3].sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("force_impl", [None, "k1", "streamed"])
def test_lanes_equal_solo_on_the_card(force_impl):
    """Bit for bit, keys included; with forces in the streamed sweep the
    floats are held to 1e-4 (integers and keys exact): torch may sum a
    row's candidates in another order at L·C rows than at C."""
    dev = _card()
    cfg = _cfg(use_forces=force_impl is not None,
               **({"force_impl": force_impl} if force_impl else {}))
    betas = [0.2, 0.35, 0.5]
    eng = EnsembleEngine(cfg, _sir(), LANES, ScenarioParams.of(beta=0.0),
                         device=dev)
    st = eng.init_state()
    for lane in range(LANES):
        st = eng.admit(st, lane, eng.stage_lane(*_inputs(lane), seed=lane),
                       ScenarioParams.of(beta=betas[lane]))
    tk1.collision_force.launches = colmap.column_map.launches = 0
    for _ in range(4):
        st = eng.step(st)
    if force_impl == "k1":
        assert tk1.collision_force.launches == 4
        assert colmap.column_map.launches == 4
    core = make_iteration_core(cfg, _sir(), dev)
    for lane in range(LANES):
        solo = Simulation(cfg, _sir(), device=dev).init_state(
            *_inputs(lane), seed=lane)
        pool, conc, rng, it = solo.pool, solo.conc, solo.rng, solo.iteration
        for _ in range(4):
            pool, conc, rng, _, _ = core(pool, conc, rng, it, None,
                                         ScenarioParams.of(beta=betas[lane]))
            it = it + 1
        got = eng.read_lane(st, lane)
        for k, v in pool.channels().items():
            g = got.pool.channels()[k]
            if force_impl == "streamed" and v.is_floating_point():
                torch.testing.assert_close(g, v, atol=1e-4, rtol=1e-4)
            else:
                assert torch.equal(v, g), (lane, k)
        assert torch.equal(rng, got.rng)


def _lane_build(dev, n_lanes=LANES):
    """An ensemble's resident build of the 2.5-diameter SIR inputs."""
    cfg = _cfg(use_forces=True)
    eng = EnsembleEngine(cfg, [], n_lanes, device=dev)
    st = eng.init_state()
    for lane in range(n_lanes):
        st = eng.admit(st, lane, eng.stage_lane(*_inputs(lane)[:2],
                                                seed=lane))
    ln = Lanes(n_lanes, CAP)
    origin = torch.zeros(3, device=dev)
    res = build_env(cfg, cfg.grid_spec, st.pool, origin, cfg.cell_size, ln)
    return cfg, ln, res.pool, res.grid


@pytest.mark.cuda
@pytest.mark.parametrize("max_pairs", [64, 4])
def test_lane_pairlist_kernel_equals_plain(max_pairs):
    """The lane-aware pair-list build ≡ its plain version entry for entry,
    each row's entries in its own lane, the demand per lane (max_pairs 4:
    rows past it overflow)."""
    dev = _card()
    cfg, ln, pool, g = _lane_build(dev)
    spec = cfg.grid_spec
    pairlist.build_list.launches = 0
    got = tgrid.build_pairlist(spec, g, pool.position, pool.alive,
                               radius=3.0 + 1.5, max_pairs=max_pairs)
    want = tgrid.build_pairlist_plain(spec, g, pool.position, pool.alive,
                                      radius=3.0 + 1.5, max_pairs=max_pairs)
    assert pairlist.build_list.launches == 1
    for f in ("idx", "run_off", "count", "demand"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert got.demand.shape == (LANES,) and bool((got.demand > 0).all())
    stored = (torch.arange(max_pairs, device=dev)
              < got.run_off[:, 9:])
    row_lane = torch.arange(LANES * CAP, device=dev)[:, None] // CAP
    assert bool(((got.idx // CAP == row_lane) | ~stored).all())
    if max_pairs == 4:
        assert bool((got.demand > 4).any())


@pytest.mark.cuda
def test_lane_pairs_column_map_kernel_equals_plain():
    """K1's inputs from an ensemble's pair list: the lane-aware pairs map
    (fused with the pack) ≡ its plain version entry for entry, per-lane
    flags too; K1 on it ≡ K1 on the stencil map (the list covers every
    pair in reach)."""
    dev = _card()
    cfg, ln, pool, g = _lane_build(dev)
    spec = cfg.grid_spec
    pairs = tgrid.build_pairlist(spec, g, pool.position, pool.alive,
                                 radius=3.0, max_pairs=64)
    active = pool.alive.clone()
    active[CAP:CAP + 40] = False
    args = (pool.position, pool.diameter, pool.agent_type, pool.alive,
            active, g.starts, g.counts, torch.zeros(3, device=dev),
            cfg.cell_size, spec.dims, 64)
    pair_cols.column_map_from_pairs.launches = 0
    got = tops.k1_inputs(*args, pairs, ln)
    want = tops.k1_inputs_plain(*args, pairs, ln)
    assert pair_cols.column_map_from_pairs.launches == 1
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert got[2].shape == (LANES,) and not bool(got[2].any())
    stencil = tops.k1_inputs(*args, None, ln)
    on_pairs = tk1.collision_force(got[0], got[1], k_rep=2.0, adhesion=None,
                                   adhesion_band=0.4)
    on_stencil = tk1.collision_force(stencil[0], stencil[1], k_rep=2.0,
                                     adhesion=None, adhesion_band=0.4)
    assert torch.equal(on_pairs, on_stencil)


@pytest.mark.cuda
def test_secretion_over_lane_offset_voxels_equals_the_cpu():
    """Secretion of 3 lanes into their own 8³ grids through one launch of
    the unchanged kernel: each voxel's amounts in slot order, ≡ the CPU's
    index_add bit for bit, and each lane ≡ its solo call."""
    dev = _card()
    spec = DiffusionSpec(dims=(8, 8, 8), voxel=2.0)
    ln = Lanes(LANES, 4096)
    r = np.random.default_rng(0)
    pos = torch.from_numpy(r.uniform(0, 16, (LANES * 4096, 3)).astype(
        np.float32))
    amount = torch.from_numpy(r.normal(size=LANES * 4096).astype(np.float32))
    conc = torch.from_numpy(r.uniform(size=(LANES, 8, 8, 8)).astype(
        np.float32))
    origin = torch.zeros(3)
    want = tdiff.add_sources(spec, conc, pos, amount, origin, ln)
    secretion.add.launches = 0
    got = tdiff.add_sources(spec, conc.to(dev), pos.to(dev), amount.to(dev),
                            origin.to(dev), ln)
    assert secretion.add.launches == 1
    assert torch.equal(got.cpu(), want)
    for lane in range(LANES):
        rows = slice(lane * 4096, (lane + 1) * 4096)
        solo = tdiff.add_sources(spec, conc[lane].to(dev), pos[rows].to(dev),
                                 amount[rows].to(dev), origin.to(dev))
        assert torch.equal(solo, got[lane])


def _clustering():
    return [tb.Secretion(rate=lambda ctx: ctx.params["secretion"]),
            tb.Chemotaxis(speed=lambda ctx: ctx.params["speed"])]


@pytest.mark.cuda
def test_clustering_lanes_equal_solo_on_the_card():
    """Clustering lanes (every_k, a skin-1.5 pair list, 16³ fields, K1):
    each lane ≡ its solo card run bit for bit, fields included; the
    pair-list build, the pairs map, K1 and secretion launch once a tick
    for every lane (the build only on ticks that rebuild)."""
    dev = _card()
    cfg = EngineConfig(
        capacity=CAP, domain_lo=(0.0,) * 3, domain_hi=(32.0,) * 3,
        interaction_radius=3.0, query_chunk=1024, max_per_box=16,
        force=ForceParams(max_displacement=0.25),
        rebuild=RebuildPolicy(mode="every_k", k=4, displacement_bound=0.75),
        pairlist=PairListConfig(skin=1.5, max_pairs=64),
        diffusion=DiffusionSpec(dims=(16, 16, 16), coefficient=0.5,
                                decay=0.01, voxel=2.0))

    def params(lane):
        return ScenarioParams.of(secretion=1.0 + 0.5 * lane,
                                 speed=0.2 + 0.1 * lane)

    def inputs(seed):
        r = np.random.default_rng(seed)
        return (r.uniform(4, 28, (160, 3)).astype(np.float32),
                np.full(160, 2.0, np.float32))
    eng = EnsembleEngine(cfg, _clustering(), LANES,
                         ScenarioParams.of(secretion=0.0, speed=0.0),
                         device=dev)
    st = eng.init_state()
    for lane in range(LANES):
        st = eng.admit(st, lane, eng.stage_lane(*inputs(lane), seed=lane),
                       params(lane))
    for k in (pairlist.build_list, pair_cols.column_map_from_pairs,
              tk1.collision_force, secretion.add):
        k.launches = 0
    rebuild_ticks = 0
    for _ in range(9):
        st = eng.step(st)
        rebuild_ticks += int(st.stats.rebuilds.any())
    assert pairlist.build_list.launches == rebuild_ticks < 9
    assert pair_cols.column_map_from_pairs.launches == 9
    assert tk1.collision_force.launches == 9 and secretion.add.launches == 9
    sim = Simulation(cfg, _clustering(), device=dev)
    core = make_iteration_core(cfg, _clustering(), dev)
    for lane in range(LANES):
        solo = sim.init_state(*inputs(lane), seed=lane)
        pool, conc, rng, it, env = (solo.pool, solo.conc, solo.rng,
                                    solo.iteration, solo.env)
        for _ in range(9):
            pool, conc, rng, _, env = core(pool, conc, rng, it, env,
                                           params(lane))
            it = it + 1
        got = eng.read_lane(st, lane)
        for k, v in pool.channels().items():
            assert torch.equal(v, got.pool.channels()[k]), (lane, k)
        assert torch.equal(conc, got.conc) and torch.equal(rng, got.rng)
        assert torch.equal(env.pairs.idx, got.env.pairs.idx)
