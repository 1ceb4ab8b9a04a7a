"""Ensemble engine: the port ≡ its own solo core ≡ the reference's ensemble.

The cases of tests/test_ensemble.py, each held against the port's solo
core (bit for bit, RNG keys included) and against the reference's
``EnsembleEngine`` run on the same numpy inputs (integers, keys and stats
exact, floats to 1e-4):

  * every lane of a 3-lane SIR ensemble with per-lane β equals its solo
    run; ``params=None`` equals the static config;
  * a retired lane is frozen with zeroed stats; a lane reused after churn
    equals a fresh one-lane run;
  * the shared-rung ladder equals a pre-sized ensemble, with the
    reference's rung schedule;
  * admit checks the params template; force overrides are refused under
    K1 with the reference's message.

And the port's own contracts: a traced dt with two diffusion substeps
rounds as the reference's; K1 over 2 lanes of 96 agents in capacity 192
(not a multiple of 128, so lanes are padded to whole row blocks) equals
the reference's vmapped Pallas K1; one tick is one program — its aten ops
are the same at 2 and at 6 lanes.
"""

import collections
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core import (EngineConfig as JConfig,  # noqa: E402
                        EnsembleCapacityLadder as JLadder,
                        EnsembleEngine as JEnsemble,
                        LadderConfig as JLadderConfig,
                        ScenarioParams as JParams, Simulation as JSim)
from repro.core import behaviors as jb  # noqa: E402
from repro.core import engine as jeng  # noqa: E402
from repro.core.diffusion import DiffusionSpec as JDiff  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import (DiffusionSpec, EngineConfig,  # noqa: E402
                              EnsembleCapacityLadder, EnsembleEngine,
                              LadderConfig, ScenarioParams, Simulation,
                              make_iteration_core)
from repro_torch.core import behaviors as tb  # noqa: E402

N, CAP = 96, 128
CPU = torch.device("cpu")


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


def _kw(**over):
    base = dict(capacity=CAP, domain_lo=(0.0,) * 3, domain_hi=(48.0,) * 3,
                interaction_radius=3.0, use_forces=False, detect_static=False,
                query_chunk=1024, max_per_box=32)
    base.update(over)
    return base


def _cfgs(**over):
    """(reference, port) configs; the reference's force_impl names map to
    the port's."""
    kw = _kw(**over)
    tkw = dict(kw)
    if "force_impl" in kw:
        tkw["force_impl"] = {"pallas": "k1", "xla": "streamed"}[
            kw["force_impl"]]
    return JConfig(**kw), EngineConfig(**tkw)


def _behaviors(mod, param=True):
    beta = (lambda ctx: ctx.params["beta"]) if param else 0.25
    return [mod.RandomWalk(sigma=0.8),
            mod.Infection(radius=3.0, beta=beta, recovery_time=40)]


def _arrays(seed, n=N):
    r = np.random.RandomState(seed)
    pos = r.uniform(0, 48, (n, 3)).astype(np.float32)
    at = np.zeros((n,), np.int32)
    at[:8] = tb.INFECTED
    timer = np.zeros((n,), np.int32)
    timer[:8] = 40
    return pos, np.full((n,), 1.0, np.float32), at, timer


def _stage(engine, seed, n=N):
    pos, dia, at, timer = _arrays(seed, n)
    return engine.stage_lane(pos, dia, at, {"infect_timer": timer},
                             seed=seed)


def _fill(engine, seeds, betas, params=ScenarioParams, n=N):
    st = engine.init_state()
    for lane, (sd, b) in enumerate(zip(seeds, betas)):
        st = engine.admit(st, lane, _stage(engine, sd, n),
                          None if b is None else params.of(beta=b))
    return st


def _solo_run(cfg, seed, beta, steps, param=True, n=N):
    """The port's solo oracle: its iteration core with (optional) params."""
    bs = _behaviors(tb, param)
    pos, dia, at, timer = _arrays(seed, n)
    st = Simulation(cfg, bs, device="cpu").init_state(
        pos, dia, at, {"infect_timer": timer}, seed=seed)
    core = make_iteration_core(cfg, bs, CPU)
    params = ScenarioParams.of(beta=beta) if param else None
    pool, conc, rng, it, env = st.pool, st.conc, st.rng, st.iteration, None
    for _ in range(steps):
        pool, conc, rng, _, env = core(pool, conc, rng, it, env, params)
        it = it + 1
    return pool, rng


def _same_pool(a, b, where):
    for name, av in a.channels().items():
        assert torch.equal(av, b.channels()[name]), \
            f"{where}: channel {name} diverged"


def _matches_reference(tlane, jlane, where):
    """A port lane ≡ the reference's lane: integers, keys and stats exact,
    floats to 1e-4."""
    for name, jv in jlane.pool.channels().items():
        w = np.asarray(jv)
        g = tlane.pool.channels()[name].numpy()
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, atol=1e-4, rtol=1e-4,
                                       err_msg=f"{where} {name}")
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"{where} {name}")
    np.testing.assert_array_equal(tlane.rng.numpy(),
                                  np.asarray(jlane.rng).astype(np.uint32),
                                  err_msg=f"{where} rng")
    assert int(tlane.iteration) == int(jlane.iteration), where
    for f in tlane.stats.keys():
        assert int(tlane.stats[f]) == int(np.asarray(jlane.stats[f])), \
            f"{where} stats {f}"


# ---------------------------------------------------------------------------
# lane-vs-solo bit-exactness
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("capacity", [CAP, 192])
def test_lanes_bit_exact_vs_solo(capacity):
    """Every lane — its own seed, its own β — reproduces its solo run bit
    for bit, keys included, and the reference ensemble's lane."""
    seeds, betas, steps = [3, 7, 11], [0.15, 0.3, 0.45], 8
    jcfg, tcfg = _cfgs(capacity=capacity)
    eng = EnsembleEngine(tcfg, _behaviors(tb), n_lanes=3,
                         params_template=ScenarioParams.of(beta=0.0),
                         device="cpu")
    st = _fill(eng, seeds, betas)
    for _ in range(steps):
        st = eng.step(st)
    assert st.iteration.tolist() == [steps] * 3
    assert int(st.tick) == steps
    jeng_ = JEnsemble(jcfg, _behaviors(jb), n_lanes=3,
                      params_template=JParams.of(beta=0.0))
    jst = _fill(jeng_, seeds, betas, JParams)
    for _ in range(steps):
        jst = jeng_.step(jst)
    for lane, (sd, b) in enumerate(zip(seeds, betas)):
        spool, srng = _solo_run(tcfg, sd, b, steps)
        got = eng.read_lane(st, lane)
        _same_pool(got.pool, spool, f"lane {lane}")
        assert torch.equal(got.rng, srng), f"lane {lane} rng diverged"
        _matches_reference(got, jeng_.read_lane(jst, lane), f"lane {lane}")


def test_params_none_matches_static_config():
    """The params plumbing is a bit-exact no-op when unused: a traced β
    equals the same β baked into the behavior, in the port, and both
    equal the reference's traced run."""
    _, tcfg = _cfgs()
    p_static, r_static = _solo_run(tcfg, 5, 0.25, steps=6, param=False)
    p_traced, r_traced = _solo_run(tcfg, 5, 0.25, steps=6, param=True)
    _same_pool(p_static, p_traced, "static-vs-traced")
    assert torch.equal(r_static, r_traced)
    jcfg, _ = _cfgs()
    bs = _behaviors(jb)
    pos, dia, at, timer = _arrays(5)
    jst = JSim(jcfg, bs).init_state(pos, dia, at, {"infect_timer": timer},
                                    seed=5)
    core = jax.jit(jeng.make_iteration_core(jcfg, bs))
    pool, conc, rng, env = jst.pool, jst.conc, jst.rng, jst.env
    it = jst.iteration
    for _ in range(6):
        pool, conc, rng, _, env = core(pool, conc, rng, it, env,
                                       JParams.of(beta=0.25))
        it = it + 1
    for name, jv in pool.channels().items():
        w = np.asarray(jv)
        g = p_traced.channels()[name].numpy()
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, atol=1e-4, rtol=1e-4)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)
    np.testing.assert_array_equal(r_traced.numpy(),
                                  np.asarray(rng).astype(np.uint32))


def test_scenario_params_of_mirrors_the_reference_dtypes():
    p = ScenarioParams.of(dt=0.5, force={"k_rep": 3}, beta=0.2,
                          recovery_time=40, flag=True)
    j = JParams.of(dt=0.5, force={"k_rep": 3}, beta=0.2, recovery_time=40,
                   flag=True)
    assert p.dt.dtype == torch.float32 and str(j.dt.dtype) == "float32"
    assert p.force["k_rep"].dtype == torch.float32
    for k in ("beta", "recovery_time", "flag"):
        assert str(p.rates[k].dtype).replace("torch.", "") == \
            str(j.rates[k].dtype), k


# ---------------------------------------------------------------------------
# lane masking: retire freezes, stats zero, reuse is independent
# ---------------------------------------------------------------------------

def _retire_run(mod, eng):
    params = ScenarioParams if mod is tb else JParams
    st = _fill(eng, [3, 7], [0.3, 0.3], params)
    for _ in range(4):
        st = eng.step(st)
    frozen = eng.read_lane(st, 0)
    st = eng.retire(st, 0)
    for _ in range(5):
        st = eng.step(st)
    return st, frozen


def test_retired_lane_frozen_and_stats_zeroed():
    jcfg, tcfg = _cfgs()
    eng = EnsembleEngine(tcfg, _behaviors(tb), n_lanes=2,
                         params_template=ScenarioParams.of(beta=0.0),
                         device="cpu")
    st, frozen = _retire_run(tb, eng)
    after = eng.read_lane(st, 0)
    _same_pool(after.pool, frozen.pool, "retired lane")
    assert torch.equal(after.rng, frozen.rng)
    # a lane's iteration advances only while it is active
    assert st.iteration.tolist() == [4, 9]
    # a frozen lane adds nothing to the stats the ladder reads
    assert int(st.stats.n_live[0]) == 0 and int(st.stats.n_live[1]) > 0
    jeng_ = JEnsemble(jcfg, _behaviors(jb), n_lanes=2,
                      params_template=JParams.of(beta=0.0))
    jst, _ = _retire_run(jb, jeng_)
    for lane in range(2):
        _matches_reference(eng.read_lane(st, lane),
                           jeng_.read_lane(jst, lane), f"lane {lane}")
    for f in st.stats.keys():
        np.testing.assert_array_equal(st.stats[f].numpy(),
                                      np.asarray(jst.stats[f]), err_msg=f)


def _churn_run(eng, params):
    st = _fill(eng, [3, 7], [0.3, 0.3], params)
    for _ in range(6):
        st = eng.step(st)
    st = eng.retire(st, 0)
    st = eng.admit(st, 0, _stage(eng, 11), params.of(beta=0.4))
    for _ in range(7):
        st = eng.step(st)
    return st


def test_lane_reuse_after_churn_matches_oracle():
    """A lane retired mid-run and given a new simulation equals a fresh
    one-lane run bit for bit: nothing of the previous occupant leaks."""
    jcfg, tcfg = _cfgs()
    eng = EnsembleEngine(tcfg, _behaviors(tb), n_lanes=2,
                         params_template=ScenarioParams.of(beta=0.0),
                         device="cpu")
    st = _churn_run(eng, ScenarioParams)
    solo = EnsembleEngine(tcfg, _behaviors(tb), n_lanes=1,
                          params_template=ScenarioParams.of(beta=0.0),
                          device="cpu")
    s1 = solo.admit(solo.init_state(), 0, _stage(solo, 11),
                    ScenarioParams.of(beta=0.4))
    for _ in range(7):
        s1 = solo.step(s1)
    lane0, oracle = eng.read_lane(st, 0), solo.read_lane(s1, 0)
    _same_pool(lane0.pool, oracle.pool, "reused lane")
    assert torch.equal(lane0.rng, oracle.rng)
    assert st.iteration.tolist() == [7, 13]        # reset on admit
    jeng_ = JEnsemble(jcfg, _behaviors(jb), n_lanes=2,
                      params_template=JParams.of(beta=0.0))
    jst = _churn_run(jeng_, JParams)
    for lane in range(2):
        _matches_reference(eng.read_lane(st, lane),
                           jeng_.read_lane(jst, lane), f"lane {lane}")


# ---------------------------------------------------------------------------
# the shared-rung ladder
# ---------------------------------------------------------------------------

def _admit_growing(engine, state):
    for lane, sd in enumerate([0, 1]):
        r = np.random.default_rng(sd)
        pos = r.uniform(4, 92, (48, 3)).astype(np.float32)
        ls = engine.stage_lane(pos, np.full(48, 5.2, np.float32), seed=sd)
        state = engine.admit(state, lane, ls)
    return state


def test_ensemble_ladder_bit_parity_vs_presized():
    """Two growing lanes under the shared-rung ladder: the rung follows the
    worst lane, the overflowing tick re-runs, and the result equals an
    ensemble pre-sized at the final rung bit for bit; the rung schedule is
    the reference's."""
    over = dict(capacity=64, domain_hi=(96.0,) * 3, interaction_radius=4.0,
                max_per_box=4, query_chunk=256)
    jcfg, tcfg = _cfgs(**over)
    steps = 7
    lad = LadderConfig(growth_factor=2.0, round_to=32)

    def scenario(mod):
        return [mod.GrowDivide(rate=0.8, threshold_diameter=6.0),
                mod.RandomWalk(sigma=0.3)]

    ladder = EnsembleCapacityLadder(tcfg, scenario(tb), n_lanes=2,
                                    ladder=lad, device="cpu")
    st = ladder.run(_admit_growing(ladder.engine, ladder.init_state()),
                    steps)
    assert any(r["field"] == "capacity" for r in ladder.rungs), ladder.rungs

    pre = EnsembleEngine(ladder.config, scenario(tb), n_lanes=2,
                         device="cpu")
    st2 = _admit_growing(pre, pre.init_state())
    for _ in range(steps):
        st2 = pre.step(st2)
    for lane in range(2):
        a, b = ladder.engine.read_lane(st, lane), pre.read_lane(st2, lane)
        _same_pool(a.pool, b.pool, f"lane {lane}")
        assert int(a.pool.alive.sum()) > 48

    jladder = JLadder(jcfg, scenario(jb), n_lanes=2,
                      ladder=JLadderConfig(growth_factor=2.0, round_to=32))
    jst = jladder.run(_admit_growing(jladder.engine, jladder.init_state()),
                      steps)
    assert ladder.rungs == jladder.rungs
    for lane in range(2):
        _matches_reference(ladder.engine.read_lane(st, lane),
                           jladder.engine.read_lane(jst, lane),
                           f"lane {lane}")


# ---------------------------------------------------------------------------
# guard rails
# ---------------------------------------------------------------------------

def test_admit_params_must_match_template():
    _, tcfg = _cfgs()
    eng = EnsembleEngine(tcfg, _behaviors(tb), n_lanes=1,
                         params_template=ScenarioParams.of(beta=0.0),
                         device="cpu")
    with pytest.raises(ValueError, match="params_template"):
        eng.admit(eng.init_state(), 0, _stage(eng, 0), None)
    with pytest.raises(ValueError, match="params_template"):
        eng.admit(eng.init_state(), 0, _stage(eng, 0),
                  ScenarioParams.of(gamma=0.1))
    eng2 = EnsembleEngine(tcfg, _behaviors(tb, param=False), n_lanes=1,
                          device="cpu")
    with pytest.raises(ValueError, match="params_template"):
        eng2.admit(eng2.init_state(), 0, _stage(eng2, 0),
                   ScenarioParams.of(beta=0.1))


def test_scenario_force_overrides_refused_under_k1():
    """K1 takes its force constants at launch, so per-run force overrides
    are refused loudly under it (the reference's message), and honoured
    by the streamed sweep."""
    _, tcfg = _cfgs(use_forces=True, force_impl="pallas")
    core = make_iteration_core(tcfg, [], CPU)
    pos, dia, _, _ = _arrays(0)
    st = Simulation(tcfg, [], device="cpu").init_state(pos, dia * 2.5)
    with pytest.raises(ValueError, match="Pallas"):
        core(st.pool, st.conc, st.rng, st.iteration, st.env,
             ScenarioParams.of(force={"k_rep": 2.0}))
    # the streamed sweep takes them: k_rep 2.0 is the static default
    scfg = dataclasses.replace(tcfg, force_impl="streamed")
    score = make_iteration_core(scfg, [], CPU)
    a = score(st.pool, st.conc, st.rng, st.iteration, st.env,
              ScenarioParams.of(force={"k_rep": 2.0}))[0]
    b = score(st.pool, st.conc, st.rng, st.iteration, st.env)[0]
    c = score(st.pool, st.conc, st.rng, st.iteration, st.env,
              ScenarioParams.of(force={"k_rep": 8.0}))[0]
    _same_pool(a, b, "k_rep override at its default")
    assert not torch.equal(a.position, c.position)


# ---------------------------------------------------------------------------
# a traced dt, K1 over padded lanes, one program per tick
# ---------------------------------------------------------------------------

def test_traced_dt_with_two_diffusion_substeps_matches_the_reference():
    """``params.dt`` is a float32 value: the substep ``dt / 2``, the
    growth ``rate·dt`` and the secretion ``rate·dt`` round as the
    reference's traced arithmetic does, not as the static Python floats."""
    over = dict(capacity=96, domain_hi=(40.0,) * 3, interaction_radius=4.0,
                use_forces=True, force_impl="xla", max_per_box=16,
                diffusion_substeps=2, dt=0.1)
    jkw, tkw = _kw(**over), _kw(**over)
    jkw["diffusion"] = JDiff(dims=(5, 5, 5), voxel=8.0, coefficient=0.3,
                             decay=0.01)
    tkw["diffusion"] = DiffusionSpec(dims=(5, 5, 5), voxel=8.0,
                                     coefficient=0.3, decay=0.01)
    tkw["force_impl"] = "streamed"
    jcfg, tcfg = JConfig(**jkw), EngineConfig(**tkw)

    def scenario(mod):
        return [mod.GrowDivide(rate=1.9, threshold_diameter=7.0),
                mod.Secretion(rate=1.3), mod.Chemotaxis(speed=0.4),
                mod.RandomWalk(sigma=0.2)]

    r = np.random.default_rng(3)
    pos = r.uniform(5, 35, (40, 3)).astype(np.float32)
    dia = np.full(40, 6.0, np.float32)
    dt = 0.37
    tst = Simulation(tcfg, scenario(tb), device="cpu").init_state(
        pos, dia, seed=2)
    jst = JSim(jcfg, scenario(jb)).init_state(pos, dia, seed=2)
    tcore = make_iteration_core(tcfg, scenario(tb), CPU)
    jcore = jax.jit(jeng.make_iteration_core(jcfg, scenario(jb)))
    tp, jp = ScenarioParams.of(dt=dt), JParams.of(dt=dt)
    t = (tst.pool, tst.conc, tst.rng, tst.iteration, None)
    j = (jst.pool, jst.conc, jst.rng, jst.iteration, None)
    births = []
    for _ in range(4):
        pool, conc, rng, tstats, env = tcore(*t, tp)
        t = (pool, conc, rng, t[3] + 1, env)
        jpool, jconc, jrng, jstats, jenv = jcore(*j, jp)
        j = (jpool, jconc, jrng, j[3] + 1, jenv)
        births.append((int(tstats.births), int(jstats.births)))
    for name, jv in j[0].channels().items():
        w, g = np.asarray(jv), t[0].channels()[name].numpy()
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, atol=1e-4, rtol=1e-4,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)
    np.testing.assert_allclose(t[1].numpy(), np.asarray(j[1]), rtol=1e-4,
                               atol=1e-4)
    assert all(a == b for a, b in births) and sum(a for a, _ in births)


def test_k1_two_lanes_in_capacity_192_match_the_reference():
    """K1 over 2 lanes of 96 agents in capacity 192: every lane is packed
    at whole 128-row blocks, so no block mixes lanes; each lane equals its
    solo K1 run bit for bit and the reference's vmapped Pallas K1
    (interpret mode) to 1e-4, nnz and keys exact."""
    jcfg, tcfg = _cfgs(capacity=192, use_forces=True, force_impl="pallas",
                       domain_hi=(30.0,) * 3)

    def stage(engine, seed):
        pos = (_arrays(seed)[0] * (30.0 / 48.0)).astype(np.float32)
        make = getattr(engine, "stage_lane", None) or engine.init_state
        return make(pos, np.full(N, 3.0, np.float32), seed=seed)

    eng = EnsembleEngine(tcfg, [], n_lanes=2, device="cpu")
    jeng_ = JEnsemble(jcfg, [], n_lanes=2)
    st, jst = eng.init_state(), jeng_.init_state()
    for lane in range(2):
        st = eng.admit(st, lane, stage(eng, lane))
        jst = jeng_.admit(jst, lane, stage(jeng_, lane))
    for _ in range(2):
        st, jst = eng.step(st), jeng_.step(jst)
    sim = Simulation(tcfg, [], device="cpu")
    for lane in range(2):
        solo = stage(sim, lane)
        for _ in range(2):
            solo = sim.step(solo)
        got = eng.read_lane(st, lane)
        _same_pool(got.pool, solo.pool, f"lane {lane}")
        assert int(got.pool.force_nnz.sum()) > 0
        _matches_reference(got, jeng_.read_lane(jst, lane), f"lane {lane}")


class _CountOps(torch.utils._python_dispatch.TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[str(func)] += 1
        return func(*args, **(kwargs or {}))


def test_one_tick_is_one_program_whatever_the_lane_count():
    """The aten ops of one ensemble tick — K1's plain path, the streamed
    sweep, births — are the same at 2 lanes as at 6 (L·C within one query
    chunk): nothing loops over the lanes."""
    _, tcfg = _cfgs(capacity=64, use_forces=True, force_impl="pallas",
                    query_chunk=1024)
    bs = _behaviors(tb) + [tb.GrowDivide(rate=0.5, threshold_diameter=1.4)]
    counts = []
    for lanes in (2, 6):
        eng = EnsembleEngine(tcfg, bs, n_lanes=lanes,
                             params_template=ScenarioParams.of(beta=0.0),
                             device="cpu")
        st = _fill(eng, range(lanes), [0.3] * lanes, n=40)
        st = eng.step(st)
        with _CountOps() as mode:
            st = eng.step(st)
        assert int(st.stats.births.sum()) > 0
        counts.append(mode.ops)
    assert counts[0] == counts[1]


def test_convert_round_trip_keeps_the_stacked_layout():
    _, tcfg = _cfgs()
    eng = EnsembleEngine(tcfg, _behaviors(tb), n_lanes=3,
                         params_template=ScenarioParams.of(beta=0.0),
                         device="cpu")
    st = eng.step(_fill(eng, [1, 2, 3], [0.1, 0.2, 0.3]))
    leaves = convert.ensemble_state_to_numpy(st)
    assert leaves["pool"]["position"].shape == (3, CAP, 3)
    assert leaves["rng"].dtype == np.uint32
    back = convert.ensemble_state_from_numpy(leaves, "cpu")
    _same_pool(back.pool, st.pool, "round trip")
    for a, b in ((back.rng, st.rng), (back.active, st.active),
                 (back.params.rates["beta"], st.params.rates["beta"]),
                 (back.tick, st.tick), (back.iteration, st.iteration)):
        assert torch.equal(a, b)
    _same_pool(eng.step(back).pool, eng.step(st).pool, "stepped on")
