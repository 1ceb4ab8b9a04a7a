"""Port engine ≡ reference engine: one step from a shared state, and the
population over many steps.

The state crosses over through ``convert.state_from_numpy`` (``np.asarray``
on every leaf of the JAX ``EngineState``). After one step integer channels
and every ``StepStats`` field must match exactly, floats to atol/rtol 1e-4 —
the tolerance tests/test_engine_kernel.py holds the reference's own two
force paths to — and the diffusion grid to 1e-5 relative. The port runs
K1's plain version (against the reference's XLA sweep or its Pallas K1)
or its streamed sweep (against the XLA sweep); each of the five scenarios
of the reference CLI is held both ways.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core import EngineConfig as JConfig  # noqa: E402
from repro.core import ForceParams as JForce, Simulation as JSim  # noqa: E402
from repro.core import health as jhealth  # noqa: E402
from repro.core.behaviors import GrowDivide as JGrow  # noqa: E402
from repro.core.behaviors import Infection as JInfection  # noqa: E402
from repro.core.behaviors import Secretion as JSecretion  # noqa: E402
from repro.core.diffusion import DiffusionSpec as JDiff  # noqa: E402
from repro.launch import simulate as jlaunch  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import EngineConfig as TConfig  # noqa: E402
from repro_torch.core import ForceParams as TForce  # noqa: E402
from repro_torch.core import GrowDivide as TGrow  # noqa: E402
from repro_torch.core import Infection as TInfection  # noqa: E402
from repro_torch.core import Secretion as TSecretion  # noqa: E402
from repro_torch.core import DiffusionSpec as TDiff  # noqa: E402
from repro_torch.core import DtypePolicy  # noqa: E402
from repro_torch.core import Simulation as TSim  # noqa: E402
from repro_torch.core import health  # noqa: E402
from repro_torch.launch import simulate as tlaunch  # noqa: E402


@pytest.fixture(autouse=True)
def _single_thread():
    """torch's multi-threaded CPU kernels were seen to return a whole
    worker's chunk of float32 sqrt results off by ~3e-4 (relative) on some
    hosts; one thread keeps the parity tests deterministic."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _partitionable_keys():
    """The port's engine splits keys as jax does with
    jax_threefry_partitionable on (jax ≥ 0.5's default)."""
    prev = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", True)
    try:
        yield
    finally:
        jax.config.update("jax_threefry_partitionable", prev)


def _leaves(st):
    return {"pool": {k: np.asarray(v) for k, v in st.pool.channels().items()},
            "rng": np.asarray(st.rng), "iteration": np.asarray(st.iteration),
            "stats": {f: np.asarray(st.stats[f]) for f in st.stats.FIELDS},
            "conc": np.asarray(st.conc)}


def _assert_states_match(want, got, atol=1e-4, rtol=1e-4):
    assert set(want["pool"]) == set(got["pool"])
    for k, w in want["pool"].items():
        g = got["pool"][k]
        assert g.dtype == w.dtype, k
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=rtol, atol=atol,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)
    for f, w in want["stats"].items():
        assert got["stats"][f].dtype == w.dtype, f
        np.testing.assert_array_equal(got["stats"][f], w, err_msg=f)
    np.testing.assert_array_equal(got["rng"], want["rng"])
    np.testing.assert_array_equal(got["iteration"], want["iteration"])


def _quickstart(capacity=1024, **change):
    """examples/quickstart.py's configuration at a reduced capacity."""
    kw = dict(capacity=capacity, domain_lo=(0, 0, 0),
              domain_hi=(120, 120, 120), interaction_radius=14.0, dt=0.2,
              sort_frequency=10, max_per_box=64, **change)
    rng = np.random.default_rng(0)
    pos = rng.uniform(50, 70, (128, 3)).astype(np.float32)
    dia = np.full(128, 8.0, np.float32)
    jsim = JSim(JConfig(**kw, force=JForce(max_displacement=1.0)),
                [JGrow(rate=1.0, threshold_diameter=12.0)])
    tsim = TSim(TConfig(**kw, force=TForce(max_displacement=1.0)),
                [TGrow(rate=1.0, threshold_diameter=12.0)], device="cpu")
    return jsim, tsim, jsim.init_state(pos, diameter=dia)


def _fig6(n):
    """benchmarks/scaling.py's Fig-6 proliferation configuration."""
    side = max(40.0, (n ** (1 / 3)) * 4.0)
    kw = dict(capacity=int(n * 1.3), domain_lo=(0, 0, 0),
              domain_hi=(side,) * 3, interaction_radius=4.0, dt=0.05,
              max_per_box=32, query_chunk=4096)
    rng = np.random.default_rng(1)
    pos = rng.uniform(2.0, side - 2.0, (n, 3)).astype(np.float32)
    jsim = JSim(JConfig(**kw, force=JForce(max_displacement=0.5)),
                [JGrow(rate=0.01, threshold_diameter=6.0)])
    tsim = TSim(TConfig(**kw, force=TForce(max_displacement=0.5)),
                [TGrow(rate=0.01, threshold_diameter=6.0)], device="cpu")
    return jsim, tsim, jsim.init_state(pos,
                                       diameter=np.full(n, 3.0, np.float32))


def _one_step(jsim, tsim, s0, until_births=False):
    s1 = jsim.step(s0)
    while until_births and int(s1.stats["births"]) == 0:
        s0, s1 = s1, jsim.step(s1)       # the first step that divides
    want = _leaves(s1)
    got = convert.state_to_numpy(tsim.step(
        convert.state_from_numpy(_leaves(s0), "cpu")))
    return want, got


def test_one_step_parity_quickstart():
    want, got = _one_step(*_quickstart(), until_births=True)
    assert int(want["stats"]["births"]) > 0
    _assert_states_match(want, got)


def test_one_step_parity_fig6():
    want, got = _one_step(*_fig6(3000))
    assert int(want["stats"]["n_live"]) == 3000
    _assert_states_match(want, got)


@pytest.mark.parametrize("adhesion", [None, ((0.3, 0.05), (0.05, 0.3))])
def test_one_step_parity_against_pallas_k1(rng, adhesion):
    """The reference's own K1 path (Pallas, interpret mode)."""
    pos = rng.uniform(4, 28, (80, 3)).astype(np.float32)
    types = rng.integers(0, 2, 80).astype(np.int32)
    kw = dict(capacity=128, domain_lo=(0, 0, 0), domain_hi=(32, 32, 32),
              interaction_radius=4.0, dt=0.1, max_per_box=64,
              adhesion=adhesion)
    jsim = JSim(JConfig(**kw, force_impl="pallas",
                        force=JForce(max_displacement=0.5)), [])
    tsim = TSim(TConfig(**kw, force=TForce(max_displacement=0.5)), [],
                device="cpu")
    s0 = jsim.init_state(pos, diameter=np.full(80, 3.0, np.float32),
                         agent_type=types)
    want, got = _one_step(jsim, tsim, s0)
    assert int(want["stats"]["n_active"]) == 80
    _assert_states_match(want, got)


def test_population_matches_over_30_steps():
    """Division depends only on diameter, which does not depend on slot
    order, so n_live and births match at every step even after float
    differences reorder slots."""
    jsim, tsim, s0 = _quickstart()
    js = s0
    ts = convert.state_from_numpy(_leaves(s0), "cpu")
    for i in range(30):
        js = jsim.step(js)
        ts = tsim.step(ts)
        for f in ("n_live", "births", "deaths", "box_overflow",
                  "birth_overflow"):
            assert int(ts.stats[f]) == int(js.stats[f]), (i, f)
        assert ts.stats.health_bits() == 0 and not ts.stats.any_overflow()
    assert int(ts.stats["n_live"]) == 256


def test_state_round_trip_bit_equal():
    jsim, _, s0 = _quickstart()
    s1 = jsim.step(s0)
    leaves = _leaves(s1)
    back = convert.state_to_numpy(convert.state_from_numpy(leaves, "cpu"))
    for k, w in leaves["pool"].items():
        assert back["pool"][k].dtype == w.dtype
        np.testing.assert_array_equal(back["pool"][k], w)
    for f, w in leaves["stats"].items():
        np.testing.assert_array_equal(back["stats"][f], w)
    assert back["rng"].dtype == np.uint32
    np.testing.assert_array_equal(back["rng"], leaves["rng"])
    np.testing.assert_array_equal(back["iteration"], leaves["iteration"])


def test_init_state_matches_reference():
    jsim, tsim, s0 = _quickstart()
    rng = np.random.default_rng(0)
    pos = rng.uniform(50, 70, (128, 3)).astype(np.float32)
    t0 = tsim.init_state(pos, diameter=np.full(128, 8.0, np.float32))
    _assert_states_match(_leaves(s0), convert.state_to_numpy(t0), 0, 0)


def test_run_raises_on_run_overflow_like_reference():
    """The reference CLI's proliferation density overflows its run
    capacity; the port raises the same error."""
    sim, st = tlaunch.build("proliferation", 10_000, "cli", device="cpu")
    with pytest.raises(RuntimeError, match="grid run overflow"):
        sim.run(st, 1, check_overflow=True)


@pytest.mark.parametrize("change", [
    dict(environment="hash_grid"),
    dict(environment="scatter_grid"),
    dict(environment="brute_force"),
])
def test_options_outside_the_slice_raise(change):
    """The environments the first slices refused now run: one step of
    each from a shared state matches the reference, the Morton sort of
    scatter and hash included (sort_frequency 1). Neither config names a
    force_impl: the port's default resolves to the streamed sweep off the
    uniform grid, as the reference's default ("xla") runs there."""
    n = 150
    kw = dict(capacity=192, domain_lo=(0, 0, 0), domain_hi=(24,) * 3,
              interaction_radius=3.0, dt=0.2, max_per_box=32,
              sort_frequency=1, **change)
    jsim = JSim(JConfig(**kw), [JGrow(rate=0.5, threshold_diameter=4.0)])
    tcfg = TConfig(**kw)
    assert tcfg.force_impl == "streamed"
    tsim = TSim(tcfg, [TGrow(rate=0.5, threshold_diameter=4.0)],
                device="cpu")
    pos = np.random.default_rng(2).uniform(1, 23, (n, 3)).astype(np.float32)
    s0 = jsim.run(jsim.init_state(pos, diameter=np.full(n, 2.0,
                                                        np.float32)), 2)
    want, got = _one_step(jsim, tsim, s0, until_births=True)
    assert int(want["stats"]["births"]) > 0
    _assert_states_match(want, got)


@pytest.mark.parametrize("env", ["scatter_grid", "hash_grid"])
def test_population_matches_over_30_steps_with_morton_sort(env):
    """The quickstart population under scatter and hash, Morton-sorted
    every 10 steps: the counts match the reference at every step."""
    jsim, tsim, s0 = _quickstart(environment=env)
    js = s0
    ts = convert.state_from_numpy(_leaves(s0), "cpu")
    for i in range(30):
        js = jsim.step(js)
        ts = tsim.step(ts)
        for f in ("n_live", "births", "deaths", "box_overflow",
                  "birth_overflow"):
            assert int(ts.stats[f]) == int(js.stats[f]), (i, f)
    assert int(ts.stats["n_live"]) == 256


def _crowd_kw(env, n=40):
    return dict(capacity=64, domain_lo=(0, 0, 0), domain_hi=(40,) * 3,
                interaction_radius=4.0, dt=0.05, max_per_box=2,
                environment=env)


def _crowd(n=40):
    rng = np.random.default_rng(8)
    return rng.uniform(17, 23, (n, 3)).astype(np.float32)


def test_run_raises_on_hash_bucket_overflow_like_reference():
    cfg = _crowd_kw("hash_grid")
    jsim = JSim(JConfig(**cfg), [])
    tsim = TSim(TConfig(**cfg), [], device="cpu")
    pos = _crowd()
    msgs = []
    for sim, st in ((jsim, jsim.init_state(pos)), (tsim,
                                                   tsim.init_state(pos))):
        with pytest.raises(RuntimeError, match="hash bucket overflow") as e:
            sim.run(st, 1, check_overflow=True)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_k1_off_the_uniform_grid_raises_like_reference():
    for env in ("hash_grid", "scatter_grid", "brute_force"):
        kw = dict(capacity=64, domain_lo=(0, 0, 0), domain_hi=(16,) * 3,
                  interaction_radius=4.0, environment=env)
        with pytest.raises(ValueError, match="requires the uniform_grid"):
            JSim(JConfig(**kw, force_impl="pallas"), [])
        with pytest.raises(ValueError, match="requires the uniform_grid"):
            TSim(TConfig(**kw, force_impl="k1"), [], device="cpu")


def test_hash_grid_ladder_grows_max_per_box_like_reference():
    """A bucket overflow grows max_per_box to ⌈demand / 4⌉'s rung, and the
    re-run step matches the reference's."""
    from repro.core.engine import CapacityLadder as JLadder
    from repro_torch.core.engine import CapacityLadder as TLadder
    cfg = _crowd_kw("hash_grid")
    pos = _crowd()
    jl = JLadder(JConfig(**cfg), [])
    tl = TLadder(TConfig(**cfg), [], device="cpu")
    js = jl.run(jl.init_state(pos), 2)
    ts = tl.run(tl.init_state(pos), 2)
    assert tl.rungs == jl.rungs
    assert any(r["field"] == "max_per_box" for r in tl.rungs)
    assert tl.config.max_per_box == jl.config.max_per_box > 2
    _assert_states_match(_leaves(js), convert.state_to_numpy(ts))


def test_every_k_queries_divide_by_the_cached_box_size():
    """radius 4 and displacement_bound 0.8 make a 4.8 box. The susceptible
    agent at z = 72.0 sits on a box boundary: the build's cell (a multiply
    by float32(1/4.8)) is 15, the every_k query's (the reference divides
    by the box size its lax.cond returns) is 14. Its 14..16 run then holds
    a crowd of 10 in box 13 first and, truncated at max_per_run 8, loses
    the infected neighbor in box 15: the agent stays susceptible on the
    build step and the skip step, in both packages."""
    kw = dict(capacity=64, domain_lo=(0, 0, 0), domain_hi=(96,) * 3,
              interaction_radius=4.0, use_forces=False, max_per_box=16,
              max_per_run=8)
    rng = np.random.default_rng(0)
    crowd = np.stack([rng.uniform(48.5, 52.5, 10),
                      rng.uniform(48.5, 52.5, 10),
                      rng.uniform(63, 66.5, 10)], 1)
    pos = np.concatenate([crowd, [[50.0, 50.0, 72.0], [50.0, 50.0, 74.0]]]
                         ).astype(np.float32)
    types = np.zeros(len(pos), np.int32)
    types[-1] = 1                                     # infected
    init = dict(agent_type=types)
    from repro.core import grid as jgrid
    from repro_torch.core import grid as tgrid
    jsim = JSim(JConfig(**kw, rebuild=jgrid.RebuildPolicy(
        "every_k", k=8, displacement_bound=0.8)),
        [JInfection(radius=4.0, beta=1.0, recovery_time=40)])
    tsim = TSim(TConfig(**kw, force_impl="streamed",
                        rebuild=tgrid.RebuildPolicy(
                            "every_k", k=8, displacement_bound=0.8)),
                [TInfection(radius=4.0, beta=1.0, recovery_time=40)],
                device="cpu")
    js = jsim.init_state(pos, **init)
    ts = tsim.init_state(pos, **init)
    for step in range(2):                     # a build, then a skip
        js, ts = jsim.step(js), tsim.step(ts)
        assert int(js.stats["rebuilds"]) == int(ts.stats["rebuilds"]) \
            == (1 if step == 0 else 0)
        want = _leaves(js)
        _assert_states_match(want, convert.state_to_numpy(ts), 0, 0)
        q = np.flatnonzero(want["pool"]["position"][:, 2] == 72.0)
        assert want["pool"]["agent_type"][q].tolist() == [0], step


@pytest.mark.parametrize("option", ["force_impl", "detect_static",
                                    "diffusion"])
def test_options_now_ported_match_reference(option):
    """The options the first slices refused now run: one step of each,
    from a shared state, against the reference (its XLA sweep; the
    port's "xla" is the streamed sweep)."""
    n = 150
    kw = dict(capacity=192, domain_lo=(0, 0, 0), domain_hi=(24,) * 3,
              interaction_radius=3.0, dt=0.2, max_per_box=32)
    jkw, tkw = dict(kw), dict(kw)
    jbeh, tbeh = [JGrow(rate=0.5, threshold_diameter=4.0)], \
        [TGrow(rate=0.5, threshold_diameter=4.0)]
    if option == "force_impl":
        tkw["force_impl"] = "xla"
    elif option == "detect_static":
        jkw["detect_static"] = tkw["detect_static"] = True
        jbeh, tbeh = [], []              # a quiet pool: most rows go static
    else:
        jkw["diffusion"] = JDiff(dims=(12, 12, 12), coefficient=0.5,
                                 decay=0.01, voxel=2.0)
        tkw["diffusion"] = TDiff(dims=(12, 12, 12), coefficient=0.5,
                                 decay=0.01, voxel=2.0)
        jbeh, tbeh = [JSecretion(rate=2.0)], [TSecretion(rate=2.0)]
    jsim = JSim(JConfig(**jkw), jbeh)
    tsim = TSim(TConfig(**tkw), tbeh, device="cpu")
    pos = np.random.default_rng(2).uniform(1, 23, (n, 3)).astype(np.float32)
    s0 = jsim.run(jsim.init_state(pos, diameter=np.full(n, 2.0,
                                                        np.float32)), 2)
    want, got = _one_step(jsim, tsim, s0)
    _assert_states_match(want, got)
    _assert_conc_match(want, got)
    if option == "detect_static":
        assert 0 < int(want["stats"]["n_active"]) < n
    if option == "diffusion":
        assert want["conc"].shape == (12, 12, 12) and want["conc"].max() > 0


def _assert_conc_match(want, got, rtol=1e-5):
    w, g = want["conc"], got["conc"]
    assert g.shape == w.shape and g.dtype == w.dtype
    np.testing.assert_allclose(g, w, rtol=rtol,
                               atol=rtol * max(float(np.abs(w).max()), 1.0))


# the reference path each port path is held against: K1 ≡ the reference's
# Pallas K1 (interpret mode), the streamed sweep ≡ its XLA sweep. The two
# reference paths differ where two agents coincide (NeuriteGrowth stages a
# bifurcation at its mother's position): K1 counts the pair in force_nnz by
# the force's magnitude, the XLA sweep by the vector, which is zero there.
_REF_IMPL = {"k1": "pallas", "streamed": "xla"}
_FORCE_SCENARIOS = ("proliferation", "neuroscience", "oncology")


@functools.lru_cache(maxsize=None)
def _scenario_step(scenario, ref_impl, n=160):
    """(state after 2 reference steps, the reference's next step) as numpy
    leaves, for the reference CLI's set-up of ``scenario``."""
    jsim, s0 = jlaunch.build(scenario, n, "xla")
    s0 = jsim.run(s0, 2)
    if ref_impl != "xla":
        jsim, _ = jlaunch.build(scenario, n, ref_impl)
    return _leaves(s0), _leaves(jsim.step(s0))


@pytest.mark.parametrize("force_impl", ["k1", "streamed"])
@pytest.mark.parametrize("scenario", tlaunch.SCENARIOS)
def test_one_step_parity_scenarios(scenario, force_impl):
    ref_impl = _REF_IMPL[force_impl] if scenario in _FORCE_SCENARIOS \
        else "xla"
    s0, want = _scenario_step(scenario, ref_impl)
    tsim, _ = tlaunch.build(scenario, 160, device="cpu",
                            force_impl=force_impl)
    got = convert.state_to_numpy(tsim.step(
        convert.state_from_numpy(s0, "cpu")))
    _assert_states_match(want, got)
    _assert_conc_match(want, got)


def test_sir_with_forces_matches_over_30_steps():
    """Forces + Infection at beta = 1: nothing random is drawn that could
    flip, so the S/I/R counts match the reference at every step, and the
    fused K1 path matches the port's sequential sweeps too."""
    n = 300
    kw = dict(capacity=n, domain_lo=(0, 0, 0), domain_hi=(28,) * 3,
              interaction_radius=4.0, dt=0.05, max_per_box=32,
              query_chunk=128, force=None)
    rng = np.random.default_rng(4)
    pos = rng.uniform(2, 26, (n, 3)).astype(np.float32)
    types = np.zeros(n, np.int32)
    types[:3] = 1
    init = dict(diameter=np.full(n, 3.0, np.float32), agent_type=types,
                extra_init={"infect_timer": np.full(n, 12, np.int32)})

    def cfg(mod, force, **extra):
        return mod(**{**kw, "force": force(max_displacement=0.5), **extra})
    jsim = JSim(cfg(JConfig, JForce),
                [JInfection(radius=4.0, beta=1.0, recovery_time=12)])
    tsims = [TSim(cfg(TConfig, TForce, **extra),
                  [TInfection(radius=4.0, beta=1.0, recovery_time=12)],
                  device="cpu")
             for extra in ({}, dict(fused_sweep=False,
                                    force_impl="streamed"))]
    js = jsim.init_state(pos, **init)
    ts = [convert.state_from_numpy(_leaves(js), "cpu") for _ in tsims]
    for i in range(30):
        js = jsim.step(js)
        ts = [sim.step(t) for sim, t in zip(tsims, ts)]
        want = np.bincount(np.asarray(js.pool.agent_type)[
            np.asarray(js.pool.alive)], minlength=3)
        for t in ts:
            got = np.bincount(t.pool.agent_type[t.pool.alive].numpy(),
                              minlength=3)
            np.testing.assert_array_equal(got, want, err_msg=f"step {i}")
            assert int(t.stats["n_live"]) == n
    assert want[2] > 0 and want[1] + want[2] > 3      # it spread, recovered


def test_fused_equals_sequential_sweeps():
    """fused_sweep=False runs forces and Infection as separate sweeps over
    the same pre-force snapshot: the same step, bit for bit."""
    n = 200
    rng = np.random.default_rng(6)
    kw = dict(capacity=n, domain_lo=(0, 0, 0), domain_hi=(20,) * 3,
              interaction_radius=3.0, max_per_box=32, query_chunk=64,
              force_impl="streamed", detect_static=True)
    types = (rng.random(n) < 0.1).astype(np.int32)
    pos = rng.uniform(1, 19, (n, 3)).astype(np.float32)
    states = []
    for fused in (True, False):
        sim = TSim(TConfig(**kw, fused_sweep=fused),
                   [TInfection(radius=3.0, beta=0.5)], device="cpu")
        st = sim.init_state(pos, diameter=np.full(n, 2.5, np.float32),
                            agent_type=types)
        states.append(sim.run(st, 4))
    a, b = states
    for k, v in a.pool.channels().items():
        assert torch.equal(v, b.pool.channels()[k]), k


def test_health_fault_injection():
    """A NaN written into a live position raises NONFINITE on the next
    step, as in the reference; flipped bits and a flag storm too."""
    jsim, tsim, s0 = _quickstart()
    ts = convert.state_from_numpy(_leaves(s0), "cpu")
    bad = health.inject_value(ts, "position", 3, float("nan"))
    jbad = jhealth.inject_value(s0, "position", 3, np.nan)
    got = health.fault_bits(tsim.step(bad).stats.health)
    want = jhealth.fault_bits(jsim.step(jbad).stats["health"])
    assert got == want == health.NONFINITE
    assert health.describe(got) == jhealth.describe(want) == ("nonfinite",)
    flipped = health.flip_bits(ts, "position", 5, 0x7FC00000)
    assert not torch.equal(flipped.pool.position[5], ts.pool.position[5])
    np.testing.assert_array_equal(
        flipped.pool.position.numpy(),
        np.asarray(jhealth.flip_bits(s0, "position", 5, 0x7FC00000
                                     ).pool.position))
    with pytest.raises(TypeError):
        health.flip_bits(ts, "agent_type", 0)
    stormy = health.storm_flags(ts, "birth_overflow", 3)
    assert stormy.stats.flags() == {"birth_overflow": 3}
    err = health.HealthFault("boom", bits=health.NONFINITE | health.ESCAPE)
    assert err.flags == ("nonfinite", "domain_escape")


def test_state_with_conc_and_extras_round_trips():
    jsim, s0 = jlaunch.build("neuroscience", 64, "xla")
    s1 = jsim.step(jsim.step(s0))
    for sc in ("clustering", "epidemiology"):
        sim, st = jlaunch.build(sc, 64, "xla")
        leaves = _leaves(sim.step(st))
        back = convert.state_to_numpy(convert.state_from_numpy(leaves, "cpu"))
        np.testing.assert_array_equal(back["conc"], leaves["conc"])
        for k, w in leaves["pool"].items():
            np.testing.assert_array_equal(back["pool"][k], w, err_msg=k)
    leaves = _leaves(s1)
    back = convert.state_to_numpy(convert.state_from_numpy(leaves, "cpu"))
    assert {"extra.direction", "extra.path_len"} <= set(back["pool"])
    for k, w in leaves["pool"].items():
        assert back["pool"][k].dtype == w.dtype
        np.testing.assert_array_equal(back["pool"][k], w, err_msg=k)


def test_narrowed_dtype_policy_raises():
    """The narrowed policies are ported; a dtype outside the reference's
    three still raises."""
    lean = DtypePolicy(aux_float="bfloat16", compact_ints=True)
    assert lean.aux_dtype == torch.bfloat16
    assert lean.int_dtype == torch.int16
    assert DtypePolicy(aux_float="float16").aux_dtype == torch.float16
    with pytest.raises(ValueError):
        DtypePolicy(aux_float="float64")


def test_config_validation_matches_reference():
    with pytest.raises(ValueError):
        TConfig(capacity=8, domain_lo=(0, 0, 0), domain_hi=(1, 1, 1),
                interaction_radius=1.0, sort_impl="bogus")
    with pytest.raises(ValueError):
        TConfig(capacity=8, domain_lo=(0, 0, 0), domain_hi=(1, 1, 1),
                interaction_radius=1.0, force_impl="pallas")
    cfg = TConfig(capacity=8, domain_lo=(0, 0, 0), domain_hi=(30, 30, 30),
                  interaction_radius=4.0)
    ref = JConfig(capacity=8, domain_lo=(0, 0, 0), domain_hi=(30, 30, 30),
                  interaction_radius=4.0)
    assert cfg.grid_spec.dims == ref.grid_spec.dims
    assert cfg.grid_spec.run_capacity == ref.grid_spec.run_capacity
