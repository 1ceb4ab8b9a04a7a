"""Sweeps of tissue models: the ensemble with every_k rebuilds, pair lists,
diffusion, static detection and per-lane force overrides.

Each case drives the reference's ``EnsembleEngine`` and the port's on the
same numpy-seeded inputs (the reference's K1 in interpret mode, as its own
tests run it on the CPU) and holds every lane of the port to its own solo
run bit for bit — pool, RNG key, diffusion grid and rebuild cache — and to
the reference's lane: integers, keys and stats exact, floats to 1e-4.

  * the clustering model (Secretion + Chemotaxis with per-lane rates, 16³
    fields, forces from a skin-1.5 pair list under every_k), with the
    streamed sweep and with K1 over the lanes' pair lists;
  * a lane admitted mid-run, whose dirty cache rebuilds while the others
    reuse theirs: a tick with mixed rebuild flags;
  * static detection per lane; per-lane ``k_rep`` overrides;
  * the ensemble ladder's ``max_pairs`` rung ≡ a pre-sized ensemble;
  * an ensemble checkpoint with its caches and fields, across the
    packages both ways;
  * the simulation service admitting and retiring tissue lanes ≡ the solo
    oracle.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core import (EngineConfig as JConfig,  # noqa: E402
                        EnsembleCapacityLadder as JLadder,
                        EnsembleEngine as JEnsemble,
                        ForceParams as JForce, LadderConfig as JLadderConfig,
                        PairListConfig as JPairs, RebuildPolicy as JRebuild,
                        ScenarioParams as JParams)
from repro.core import behaviors as jb  # noqa: E402
from repro.core import simcheck as jsimcheck  # noqa: E402
from repro.core.diffusion import DiffusionSpec as JDiff  # noqa: E402
from repro_torch.core import (DiffusionSpec, EngineConfig,  # noqa: E402
                              EnsembleCapacityLadder, EnsembleEngine,
                              ForceParams, LadderConfig, PairListConfig,
                              RebuildPolicy, ScenarioParams, Simulation,
                              make_iteration_core, simcheck)
from repro_torch.core import behaviors as tb  # noqa: E402
from repro_torch.core import grid as tgrid  # noqa: E402
from repro_torch.serve.sim_service import SimRequest, SimService  # noqa: E402

CPU = torch.device("cpu")
N, CAP, SIDE = 160, 192, 32.0


@pytest.fixture(autouse=True)
def _single_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True, scope="module")
def _partitionable_keys():
    prev = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", True)
    yield
    jax.config.update("jax_threefry_partitionable", prev)


# ---------------------------------------------------------------------------
# set-ups: (reference, port) configs and behaviors on the same inputs
# ---------------------------------------------------------------------------

def _pair(force_impl="xla", **over):
    """(reference, port) configs of the clustering model with contact
    forces from a pair list under every_k (examples/cell_clustering.py
    --pairlist at 160 agents in 32³), with ``over`` applied to both."""
    j = dict(capacity=CAP, domain_lo=(0.0,) * 3, domain_hi=(SIDE,) * 3,
             interaction_radius=3.0, query_chunk=1024, max_per_box=16,
             use_forces=True, force_impl=force_impl,
             force=JForce(max_displacement=0.25),
             rebuild=JRebuild(mode="every_k", k=4, displacement_bound=0.75),
             pairlist=JPairs(skin=1.5, max_pairs=64),
             diffusion=JDiff(dims=(16, 16, 16), coefficient=0.5, decay=0.01,
                             voxel=2.0))
    j.update(over)
    t = dict(j, force_impl={"pallas": "k1", "xla": "streamed"}[force_impl],
             force=ForceParams(**dataclasses.asdict(j["force"])))
    for k, cls in (("rebuild", RebuildPolicy), ("pairlist", PairListConfig),
                   ("diffusion", DiffusionSpec)):
        if j.get(k) is not None:
            t[k] = cls(**dataclasses.asdict(j[k]))
    return JConfig(**j), EngineConfig(**t)


def _clustering(mod):
    """Secretion and Chemotaxis with per-lane rates (``ctx.params``)."""
    return [mod.Secretion(rate=lambda ctx: ctx.params["secretion"]),
            mod.Chemotaxis(speed=lambda ctx: ctx.params["speed"])]


def _cluster_params(cls, lane):
    return cls.of(secretion=1.0 + 0.5 * lane, speed=0.2 + 0.1 * lane)


def _cluster_inputs(seed, n=N):
    r = np.random.default_rng(seed)
    pos = r.uniform(4, SIDE - 4, (n, 3)).astype(np.float32)
    return pos, np.full(n, 2.0, np.float32)


def _fill(engine, seeds, params_of, inputs=_cluster_inputs, cls=None):
    st = engine.init_state()
    for lane, sd in enumerate(seeds):
        st = engine.admit(st, lane, engine.stage_lane(*inputs(sd), seed=sd),
                          None if params_of is None else params_of(cls, lane))
    return st


def _solo_run(cfg, behaviors, inputs, seed, params, steps):
    """The port's solo oracle: its iteration core with ``params``."""
    st = Simulation(cfg, behaviors, device="cpu").init_state(*inputs,
                                                             seed=seed)
    core = make_iteration_core(cfg, behaviors, CPU)
    pool, conc, rng, it, env = (st.pool, st.conc, st.rng, st.iteration,
                                st.env)
    for _ in range(steps):
        pool, conc, rng, _, env = core(pool, conc, rng, it, env, params)
        it = it + 1
    return pool, conc, rng, env


def _env_leaves(env):
    """name → tensor of a solo cache's array leaves."""
    out = {f"grid.{f}": getattr(env.grid, f) for f in tgrid._GRID_LEAVES}
    out.update(steps_since=env.steps_since, disp_accum=env.disp_accum,
               dirty=env.dirty)
    if env.pairs is not None:
        out.update({f"pairs.{f}": getattr(env.pairs, f)
                    for f in tgrid._PAIR_LEAVES}, pair_disp=env.pair_disp)
    return out


def _same_lane(got, pool, conc, rng, env, where):
    """A port lane ≡ its solo run bit for bit."""
    for name, v in pool.channels().items():
        assert torch.equal(got.pool.channels()[name], v), \
            f"{where}: channel {name}"
    assert torch.equal(got.conc, conc), f"{where}: conc"
    assert torch.equal(got.rng, rng), f"{where}: rng"
    if env is not None:
        for name, v in _env_leaves(env).items():
            assert torch.equal(_env_leaves(got.env)[name], v), \
                f"{where}: env {name}"


def _close(g, w, where):
    w = np.asarray(w)
    g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
    if w.dtype.kind == "f":
        np.testing.assert_allclose(g, w, atol=1e-4, rtol=1e-4, err_msg=where)
    else:
        np.testing.assert_array_equal(g, w.astype(g.dtype), err_msg=where)


def _matches_reference(tlane, jlane, where):
    """A port lane ≡ the reference's lane: integers, keys, stats and the
    cache's tables exact, floats (the diffusion grid too) to 1e-4."""
    for name, jv in jlane.pool.channels().items():
        _close(tlane.pool.channels()[name], jv, f"{where} {name}")
    _close(tlane.conc, jlane.conc, f"{where} conc")
    _close(tlane.rng, np.asarray(jlane.rng).astype(np.uint32),
           f"{where} rng")
    assert int(tlane.iteration) == int(jlane.iteration), where
    for f in tlane.stats.keys():
        assert int(tlane.stats[f]) == int(np.asarray(jlane.stats[f])), \
            f"{where} stats {f}"
    if jlane.env is not None:
        want = {f"grid.{f}": getattr(jlane.env.grid, f)
                for f in tgrid._GRID_LEAVES}
        want.update(steps_since=jlane.env.steps_since,
                    disp_accum=jlane.env.disp_accum, dirty=jlane.env.dirty)
        if jlane.env.pairs is not None:
            want.update({f"pairs.{f}": getattr(jlane.env.pairs, f)
                         for f in tgrid._PAIR_LEAVES},
                        pair_disp=jlane.env.pair_disp)
        got = _env_leaves(tlane.env)
        for name, w in want.items():
            _close(got[name], w, f"{where} env {name}")


def _engines(jcfg, tcfg, behaviors, lanes, template):
    jt, tt = template
    return (EnsembleEngine(tcfg, behaviors(tb), n_lanes=lanes,
                           params_template=tt, device="cpu"),
            JEnsemble(jcfg, behaviors(jb), n_lanes=lanes, params_template=jt))


CLUSTER_TEMPLATE = (JParams.of(secretion=0.0, speed=0.0),
                    ScenarioParams.of(secretion=0.0, speed=0.0))


# ---------------------------------------------------------------------------
# the clustering lanes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("force_impl", ["xla", "pallas"])
def test_clustering_lanes_equal_solo_and_reference(force_impl):
    """Three clustering lanes (their own seeds, secretion rates and
    chemotaxis speeds) with contact forces from a skin-1.5 pair list under
    every_k: every lane ≡ its solo run bit for bit (grid and cache
    included) and ≡ the reference's lane — with the streamed sweep, and
    with K1 over the three lanes' pair lists in one launch."""
    jcfg, tcfg = _pair(force_impl)
    seeds, steps = [3, 7, 11], 9
    eng, jeng = _engines(jcfg, tcfg, _clustering, 3, CLUSTER_TEMPLATE)
    st = _fill(eng, seeds, _cluster_params, cls=ScenarioParams)
    jst = _fill(jeng, seeds, _cluster_params, cls=JParams)
    rebuilds = np.zeros(3, np.int64)
    for _ in range(steps):
        st, jst = eng.step(st), jeng.step(jst)
        rebuilds += st.stats.rebuilds.numpy()
    assert 0 < rebuilds.min() and rebuilds.max() < steps, rebuilds
    assert int(st.stats.pair_demand.min()) > 0
    assert float(st.conc.amax()) > 0 and int(st.pool.force_nnz.sum()) > 0
    for lane, sd in enumerate(seeds):
        want = _solo_run(tcfg, _clustering(tb), _cluster_inputs(sd), sd,
                         _cluster_params(ScenarioParams, lane), steps)
        got = eng.read_lane(st, lane)
        _same_lane(got, *want, f"lane {lane}")
        _matches_reference(got, jeng.read_lane(jst, lane), f"lane {lane}")


def test_a_tick_with_mixed_rebuild_flags():
    """Lane 1 is admitted at tick 1 with a fresh dirty cache: it rebuilds
    while lane 0 reuses its cache, so that tick builds both lanes and
    keeps each lane's own choice. Both lanes ≡ their solo runs and the
    reference's lanes, through the tick and after."""
    jcfg, tcfg = _pair("pallas")
    eng, jeng = _engines(jcfg, tcfg, _clustering, 2, CLUSTER_TEMPLATE)

    def run(engine, cls):
        st = _fill(engine, [3], _cluster_params, cls=cls)
        flags = []
        for tick in range(7):
            if tick == 1:
                st = engine.admit(st, 1, engine.stage_lane(
                    *_cluster_inputs(5), seed=5), _cluster_params(cls, 1))
            st = engine.step(st)
            flags.append(np.asarray(st.stats.rebuilds).tolist())
        return st, flags

    st, flags = run(eng, ScenarioParams)
    jst, jflags = run(jeng, JParams)
    assert flags == jflags
    assert flags[1] == [0, 1], flags
    for lane, (sd, steps) in enumerate([(3, 7), (5, 6)]):
        want = _solo_run(tcfg, _clustering(tb), _cluster_inputs(sd), sd,
                         _cluster_params(ScenarioParams, lane), steps)
        got = eng.read_lane(st, lane)
        _same_lane(got, *want, f"lane {lane}")
        _matches_reference(got, jeng.read_lane(jst, lane), f"lane {lane}")


# ---------------------------------------------------------------------------
# static detection and per-lane force constants
# ---------------------------------------------------------------------------

def _front_inputs(seed, n=N):
    """A loose lattice with its first rows random-walking (the 'front' of
    benchmarks/optimizations.py, cut to ``n`` agents), so some boxes go
    static."""
    g = np.stack(np.meshgrid(*[np.arange(6)] * 3, indexing="ij"),
                 -1).reshape(-1, 3)[:n]
    pos = (4.0 + 4.0 * g).astype(np.float32)
    pos += np.random.default_rng(seed).uniform(-0.3, 0.3, pos.shape).astype(
        np.float32)
    return pos, np.full(len(pos), 3.6, np.float32)


def _walkers(mod):
    """RandomWalk on each lane's first 24 slots only: a moving front."""
    where, asarray = ((torch.where, torch.from_numpy) if mod is tb
                      else (jax.numpy.where, jax.numpy.asarray))

    class FrontWalk(mod.RandomWalk):
        name = "front_walk"

        def __call__(self, ctx, pool, rng):
            eff = super().__call__(ctx, pool, rng)
            moving = asarray((np.arange(pool.capacity) % CAP) < 24)
            return dataclasses.replace(eff, set_channels={
                "position": where(moving[:, None],
                                  eff.set_channels["position"],
                                  pool.position)})
    return [FrontWalk(sigma=0.5)]


def test_static_detection_lanes_equal_solo_and_reference():
    """detect_static over 2 lanes with K1: each lane's boxes are its own
    (a lane-offset disturbance table, the 3×3×3 window over (L, X, Y, Z)),
    static rows drop out of K1's query mask, and each lane ≡ its solo run
    and the reference's lane."""
    jcfg, tcfg = _pair("pallas", rebuild=JRebuild(), pairlist=None,
                       diffusion=None, detect_static=True, max_per_box=8)
    eng = EnsembleEngine(tcfg, _walkers(tb), n_lanes=2, device="cpu")
    jeng = JEnsemble(jcfg, _walkers(jb), n_lanes=2)
    seeds, steps = [1, 2], 5
    st = _fill(eng, seeds, None, _front_inputs)
    jst = _fill(jeng, seeds, None, _front_inputs)
    for _ in range(steps):
        st, jst = eng.step(st), jeng.step(jst)
    n_static = st.pool.static.reshape(2, -1).sum(1)
    assert bool((n_static > 0).all()), n_static
    for lane, sd in enumerate(seeds):
        want = _solo_run(tcfg, _walkers(tb), _front_inputs(sd), sd, None,
                         steps)
        got = eng.read_lane(st, lane)
        _same_lane(got, *want, f"lane {lane}")
        _matches_reference(got, jeng.read_lane(jst, lane), f"lane {lane}")


def test_per_lane_k_rep_overrides_in_the_streamed_sweep():
    """ScenarioParams.force over 2 lanes (k_rep 2.0 and 6.0): the streamed
    sweep's pair function reads each query row's own constants, so each
    lane ≡ its solo run with its k_rep and the reference's lane."""
    jcfg, tcfg = _pair("xla", rebuild=JRebuild(), pairlist=None,
                       diffusion=None)
    k_reps, seeds, steps = [2.0, 6.0], [4, 9], 4

    def params(cls, lane):
        return cls.of(force={"k_rep": k_reps[lane]})
    tmpl = (JParams.of(force={"k_rep": 0.0}),
            ScenarioParams.of(force={"k_rep": 0.0}))
    eng, jeng = _engines(jcfg, tcfg, lambda mod: [], 2, tmpl)
    st = _fill(eng, seeds, params, _front_inputs, ScenarioParams)
    jst = _fill(jeng, seeds, params, _front_inputs, JParams)
    for _ in range(steps):
        st, jst = eng.step(st), jeng.step(jst)
    for lane, sd in enumerate(seeds):
        want = _solo_run(tcfg, [], _front_inputs(sd), sd,
                         params(ScenarioParams, lane), steps)
        got = eng.read_lane(st, lane)
        _same_lane(got, *want, f"lane {lane}")
        _matches_reference(got, jeng.read_lane(jst, lane), f"lane {lane}")
    a, b = (eng.read_lane(st, lane).pool.position for lane in range(2))
    assert not torch.equal(a, b)


# ---------------------------------------------------------------------------
# the ladder's max_pairs rung, checkpoints, the service
# ---------------------------------------------------------------------------

def test_ladder_max_pairs_rung_equals_presized():
    """A pair list too narrow for the lanes' demand: the ensemble ladder
    logs a max_pairs rung (the reference's schedule), grows every lane's
    cache and list, re-runs the tick, and ends bit-equal to an ensemble
    pre-sized at the final rung."""
    jcfg, tcfg = _pair("xla", pairlist=JPairs(skin=1.5, max_pairs=8))
    seeds, steps = [3, 7], 6
    lad = LadderConfig(growth_factor=2.0, round_to=32)
    ladder = EnsembleCapacityLadder(tcfg, _clustering(tb), n_lanes=2,
                                    params_template=CLUSTER_TEMPLATE[1],
                                    ladder=lad, device="cpu")
    st = ladder.run(_fill(ladder.engine, seeds, _cluster_params,
                          cls=ScenarioParams), steps)
    assert [r["field"] for r in ladder.rungs] == ["max_pairs"], ladder.rungs
    pre = EnsembleEngine(ladder.config, _clustering(tb), n_lanes=2,
                         params_template=CLUSTER_TEMPLATE[1], device="cpu")
    st2 = _fill(pre, seeds, _cluster_params, cls=ScenarioParams)
    for _ in range(steps):
        st2 = pre.step(st2)
    for lane in range(2):
        a, b = ladder.engine.read_lane(st, lane), pre.read_lane(st2, lane)
        _same_lane(a, b.pool, b.conc, b.rng, b.env, f"lane {lane}")
    jladder = JLadder(jcfg, _clustering(jb), n_lanes=2,
                      params_template=CLUSTER_TEMPLATE[0],
                      ladder=JLadderConfig(growth_factor=2.0, round_to=32))
    jst = jladder.run(_fill(jladder.engine, seeds, _cluster_params,
                            cls=JParams), steps)
    assert ladder.rungs == jladder.rungs
    for lane in range(2):
        _matches_reference(ladder.engine.read_lane(st, lane),
                           jladder.engine.read_lane(jst, lane),
                           f"lane {lane}")


def test_ensemble_checkpoint_with_caches_crosses_both_ways(tmp_path):
    """An ensemble checkpoint holding every lane's warm cache, pair list
    and field, in the reference's (L, ...) layout: written by the port and
    restored by the reference, and the other way, each steps on as the
    uninterrupted run."""
    jcfg, tcfg = _pair("xla")
    eng, jeng = _engines(jcfg, tcfg, _clustering, 2, CLUSTER_TEMPLATE)
    st = _fill(eng, [3, 7], _cluster_params, cls=ScenarioParams)
    jst = _fill(jeng, [3, 7], _cluster_params, cls=JParams)
    for _ in range(3):
        st, jst = eng.step(st), jeng.step(jst)
    st = eng.retire(st, 1)
    jst = jeng.retire(jst, 1)
    simcheck.save_ensemble_state(str(tmp_path / "port"), st, tcfg)
    jsimcheck.save_ensemble_state(str(tmp_path / "ref"), jst, jcfg)
    jback, _, _ = jsimcheck.restore_ensemble_state(
        str(tmp_path / "port"), jcfg, _clustering(jb),
        CLUSTER_TEMPLATE[0])
    tback, _, _ = simcheck.restore_ensemble_state(
        str(tmp_path / "ref"), tcfg, _clustering(tb), CLUSTER_TEMPLATE[1],
        device="cpu")
    own, _, _ = simcheck.restore_ensemble_state(
        str(tmp_path / "port"), tcfg, _clustering(tb), CLUSTER_TEMPLATE[1],
        device="cpu")
    for _ in range(3):
        st, own, jst = eng.step(st), eng.step(own), jeng.step(jst)
        jback, tback = jeng.step(jback), eng.step(tback)
    for lane in range(2):
        want = eng.read_lane(st, lane)
        _same_lane(eng.read_lane(own, lane), want.pool, want.conc, want.rng,
                   want.env, f"port round trip lane {lane}")
        _matches_reference(want, jeng.read_lane(jback, lane),
                           f"port → reference lane {lane}")
        _matches_reference(eng.read_lane(tback, lane),
                           jeng.read_lane(jst, lane),
                           f"reference → port lane {lane}")


def test_service_admits_and_retires_tissue_lanes():
    """The simulation service over 2 clustering lanes and 3 requests: the
    third is admitted into a retired lane with a fresh dirty cache; every
    retired simulation ≡ its solo run for its steps (pool, field, key and
    cache)."""
    _, tcfg = _pair("pallas")
    svc = SimService(tcfg, _clustering(tb), n_lanes=2,
                     params_template=CLUSTER_TEMPLATE[1], device="cpu")
    budgets = {0: 3, 1: 5, 2: 4}
    for uid, steps in budgets.items():
        pos, dia = _cluster_inputs(uid)
        svc.submit(SimRequest(uid=uid, position=pos, diameter=dia, seed=uid,
                              params=_cluster_params(ScenarioParams, uid),
                              max_steps=steps))
    ticks = svc.run_until_drained(50)
    assert ticks == 7 and sorted(f.uid for f in svc.finished) == [0, 1, 2]
    assert [f.lane for f in sorted(svc.finished, key=lambda f: f.uid)] == \
        [0, 1, 0]
    for f in svc.finished:
        want = _solo_run(tcfg, _clustering(tb), _cluster_inputs(f.uid),
                         f.uid, _cluster_params(ScenarioParams, f.uid),
                         budgets[f.uid])
        _same_lane(f.final, *want, f"uid {f.uid}")
