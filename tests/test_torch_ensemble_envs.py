"""The ensemble under the scatter grid, the spatial hash and brute force.

Each case drives the reference's ``EnsembleEngine`` (its vmapped solo
core) and the port's lane-major one on the same numpy-seeded inputs, and
holds every lane of the port to its own solo run bit for bit (pool and RNG
key) and to the reference's lane: integers, keys and stats exact, floats
to 1e-4.

  * tests/test_ensemble.py's SIR model, 3 lanes with per-lane β, under
    each of the three environments;
  * the periodic Morton sort with a lane admitted late, so lanes sort on
    different ticks;
  * brute force with static detection and contact forces;
  * the hash rung of ``EnsembleCapacityLadder`` (``max_per_box``) ≡ an
    ensemble pre-sized at the final rung, with the reference's rungs.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core import (EngineConfig as JConfig,  # noqa: E402
                        EnsembleCapacityLadder as JLadder,
                        EnsembleEngine as JEnsemble,
                        LadderConfig as JLadderConfig,
                        ScenarioParams as JParams)
from repro.core import behaviors as jb  # noqa: E402
from repro_torch.core import (EngineConfig,  # noqa: E402
                              EnsembleCapacityLadder, EnsembleEngine,
                              LadderConfig, ScenarioParams, Simulation,
                              make_iteration_core)
from repro_torch.core import behaviors as tb  # noqa: E402

CPU = torch.device("cpu")
N, CAP = 96, 128
ENVS = ["scatter_grid", "hash_grid", "brute_force"]


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


def _cfgs(**over):
    """(reference, port) configs: tests/test_ensemble.py's SIR set-up with
    ``over`` applied to both (neither names a force_impl: each package's
    default off the uniform grid is its streamed sweep)."""
    kw = dict(capacity=CAP, domain_lo=(0.0,) * 3, domain_hi=(48.0,) * 3,
              interaction_radius=3.0, use_forces=False, detect_static=False,
              query_chunk=1024, max_per_box=32)
    kw.update(over)
    return JConfig(**kw), EngineConfig(**kw)


def _sir(mod, param=True):
    beta = (lambda ctx: ctx.params["beta"]) if param else 0.25
    return [mod.RandomWalk(sigma=0.8),
            mod.Infection(radius=3.0, beta=beta, recovery_time=40)]


def _arrays(seed, n=N, side=48.0):
    r = np.random.RandomState(seed)
    pos = r.uniform(0, side, (n, 3)).astype(np.float32)
    at = np.zeros((n,), np.int32)
    at[:8] = tb.INFECTED
    timer = np.zeros((n,), np.int32)
    timer[:8] = 40
    return pos, np.full((n,), 1.0, np.float32), at, timer


def _stage(engine, seed, **kw):
    pos, dia, at, timer = _arrays(seed, **kw)
    return engine.stage_lane(pos, dia, at, {"infect_timer": timer},
                             seed=seed)


def _run(engine, params, seeds, betas, ticks, late=None):
    """Admit a lane per seed (β from ``betas``, None: no params) and step
    ``ticks`` ticks; the lane ``late`` is admitted only after tick 3."""
    st = engine.init_state()

    def admit(st, lane):
        b = betas[lane]
        return engine.admit(st, lane, _stage(engine, seeds[lane]),
                            None if b is None else params.of(beta=b))
    for lane in range(len(seeds)):
        if lane != late:
            st = admit(st, lane)
    for t in range(ticks):
        if t == 3 and late is not None:
            st = admit(st, late)
        st = engine.step(st)
    return st


def _solo(cfg, behaviors, seed, beta, steps):
    """The port's solo oracle: its iteration core, ``steps`` steps."""
    pos, dia, at, timer = _arrays(seed)
    st = Simulation(cfg, behaviors, device="cpu").init_state(
        pos, dia, at, {"infect_timer": timer}, seed=seed)
    core = make_iteration_core(cfg, behaviors, CPU)
    params = None if beta is None else ScenarioParams.of(beta=beta)
    pool, conc, rng, it, env = st.pool, st.conc, st.rng, st.iteration, None
    for _ in range(steps):
        pool, conc, rng, stats, env = core(pool, conc, rng, it, env, params)
        it = it + 1
    return pool, rng, stats


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


def _check_lanes(tcfg, behaviors, eng, st, jeng, jst, seeds, betas):
    """Every lane ≡ its solo run (pool, key, stats) and ≡ the reference."""
    for lane, (sd, b) in enumerate(zip(seeds, betas)):
        got = eng.read_lane(st, lane)
        pool, rng, stats = _solo(tcfg, behaviors, sd, b, int(got.iteration))
        _same_pool(got.pool, pool, f"lane {lane}")
        assert torch.equal(got.rng, rng), f"lane {lane} rng diverged"
        for f in stats.keys():
            assert int(got.stats[f]) == int(stats[f]), f"lane {lane} {f}"
        _matches_reference(got, jeng.read_lane(jst, lane), f"lane {lane}")


# ---------------------------------------------------------------------------
# each environment over 3 lanes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("env", ENVS)
def test_lanes_match_solo_and_reference(env):
    """3 SIR lanes with their own seeds and β: each equals its solo run
    bit for bit and the reference's vmapped lane; the hash reports each
    lane's own bucket demand."""
    seeds, betas, ticks = [3, 7, 11], [0.15, 0.3, 0.45], 6
    jcfg, tcfg = _cfgs(environment=env)
    eng = EnsembleEngine(tcfg, _sir(tb), n_lanes=3,
                         params_template=ScenarioParams.of(beta=0.0),
                         device="cpu")
    st = _run(eng, ScenarioParams, seeds, betas, ticks)
    jeng = JEnsemble(jcfg, _sir(jb), n_lanes=3,
                     params_template=JParams.of(beta=0.0))
    jst = _run(jeng, JParams, seeds, betas, ticks)
    assert st.iteration.tolist() == [ticks] * 3
    _check_lanes(tcfg, _sir(tb), eng, st, jeng, jst, seeds, betas)
    np.testing.assert_array_equal(st.stats.box_demand.numpy(),
                                  np.asarray(jst.stats.box_demand))
    if env == "hash_grid":
        assert int(st.stats.box_demand.min()) > 0


@pytest.mark.parametrize("env", ["scatter_grid", "hash_grid"])
def test_morton_sort_per_lane_with_a_late_lane(env):
    """``sort_frequency=4`` with lane 1 admitted after tick 3: the lanes
    sort on their own iterations, on different ticks, each as its solo
    run and as the reference's vmapped ``lax.cond``."""
    seeds, betas, ticks = [5, 9], [0.3, 0.4], 9
    jcfg, tcfg = _cfgs(environment=env, sort_frequency=4)
    eng = EnsembleEngine(tcfg, _sir(tb), n_lanes=2,
                         params_template=ScenarioParams.of(beta=0.0),
                         device="cpu")
    st = _run(eng, ScenarioParams, seeds, betas, ticks, late=1)
    jeng = JEnsemble(jcfg, _sir(jb), n_lanes=2,
                     params_template=JParams.of(beta=0.0))
    jst = _run(jeng, JParams, seeds, betas, ticks, late=1)
    assert st.iteration.tolist() == [ticks, ticks - 3]
    _check_lanes(tcfg, _sir(tb), eng, st, jeng, jst, seeds, betas)
    # the sort reordered the slots: a lane is not in its staged order
    staged = _stage(eng, seeds[0]).pool.position
    assert not torch.equal(eng.read_lane(st, 0).pool.position, staged)


def test_brute_force_with_statics_and_forces():
    """Brute force keeps the resident tables for the static detection:
    over lanes, with contact forces on and ``detect_static``, each lane
    equals its solo run and the reference's lane."""
    seeds, betas, ticks = [2, 4], [None, None], 6
    over = dict(environment="brute_force", use_forces=True,
                detect_static=True, domain_hi=(24.0,) * 3,
                interaction_radius=4.0, max_per_box=16)
    jcfg, tcfg = _cfgs(**over)

    def scenario(mod):
        return [mod.RandomWalk(sigma=0.0)]

    eng = EnsembleEngine(tcfg, scenario(tb), n_lanes=2, device="cpu")
    jeng = JEnsemble(jcfg, scenario(jb), n_lanes=2)

    def run(engine):
        st = engine.init_state()
        for lane, sd in enumerate(seeds):
            pos, dia, _, _ = _arrays(sd, n=64, side=24.0)
            st = engine.admit(st, lane, engine.stage_lane(
                pos, np.full(64, 3.5, np.float32), seed=sd))
        for _ in range(ticks):
            st = engine.step(st)
        return st
    st, jst = run(eng), run(jeng)
    for lane, sd in enumerate(seeds):
        pos, _, _, _ = _arrays(sd, n=64, side=24.0)
        solo = Simulation(tcfg, scenario(tb), device="cpu")
        s1 = solo.init_state(pos, np.full(64, 3.5, np.float32), seed=sd)
        for _ in range(ticks):
            s1 = solo.step(s1)
        got = eng.read_lane(st, lane)
        _same_pool(got.pool, s1.pool, f"lane {lane}")
        assert torch.equal(got.rng, s1.rng)
        _matches_reference(got, jeng.read_lane(jst, lane), f"lane {lane}")
    # the lanes have settled into static agents and still feel forces
    assert bool(st.pool.static.any())
    assert bool(st.pool.force_nnz.any())


# ---------------------------------------------------------------------------
# the hash rung of the ensemble ladder
# ---------------------------------------------------------------------------

def test_hash_ladder_grows_max_per_box_like_a_presized_ensemble():
    """Crowded lanes under the hash with ``max_per_box=1`` (a probe width
    of 4): the ladder grows ``max_per_box`` from the worst lane's bucket
    demand, and the result equals an ensemble pre-sized at the final rung
    bit for bit; the rungs are the reference's."""
    over = dict(environment="hash_grid", domain_hi=(12.0,) * 3,
                max_per_box=1)
    jcfg, tcfg = _cfgs(**over)
    seeds, ticks = [1, 6], 5
    lad = dict(growth_factor=2.0, round_to=32)

    def run(engine):
        st = engine.init_state()
        for lane, sd in enumerate(seeds):
            st = engine.admit(st, lane, _stage(engine, sd, side=12.0))
        return st

    ladder = EnsembleCapacityLadder(tcfg, _sir(tb, param=False), n_lanes=2,
                                    ladder=LadderConfig(**lad), device="cpu")
    st = ladder.run(run(ladder.engine), ticks)
    assert [r["field"] for r in ladder.rungs] == ["max_per_box"], \
        ladder.rungs
    assert ladder.config.max_per_box > 1
    pre = EnsembleEngine(ladder.config, _sir(tb, param=False), n_lanes=2,
                         device="cpu")
    st2 = run(pre)
    for _ in range(ticks):
        st2 = pre.step(st2)
    for lane in range(2):
        a, b = ladder.engine.read_lane(st, lane), pre.read_lane(st2, lane)
        _same_pool(a.pool, b.pool, f"lane {lane}")
        assert torch.equal(a.rng, b.rng)
    assert int(st.stats.box_overflow.sum()) == 0

    jladder = JLadder(jcfg, _sir(jb, param=False), n_lanes=2,
                      ladder=JLadderConfig(**lad))
    jst = jladder.run(run(jladder.engine), ticks)
    assert ladder.rungs == jladder.rungs
    for lane in range(2):
        _matches_reference(ladder.engine.read_lane(st, lane),
                           jladder.engine.read_lane(jst, lane),
                           f"lane {lane}")
