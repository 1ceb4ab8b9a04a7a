"""Checkpoints and the supervised run: the port ≡ the reference.

* ``repro_torch.train.checkpoint``: the corner cases of
  tests/test_checkpoint.py (GC window, crash debris, a stale ``LATEST``,
  mismatch messages, manifest extras), and the reference's format: the
  same leaf key strings, the same manifest, the same arrays.
* ``repro_torch.core.simcheck``: the single-device tests of
  tests/test_fault_tolerance.py — bit-exact round trips with and without
  the every_k cache, the cache adapted across rebuild modes, a
  non-simulation checkpoint refused, the degradation order, NaN rollback,
  the re-raise with its report, the capacity-exhaustion emergency
  checkpoint, and a SIGKILLed ladder run resumed bit-exact in child
  processes that import no JAX (one resumed through the CLI).
* Across packages: a checkpoint written by ``repro.core.save_state``
  restores into the port and steps as the reference's next step
  (integers exact, floats 1e-4), and one written by the port restores into
  the reference, bit for bit.
"""

import json
import os
import signal
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import simcheck as jsimcheck  # noqa: E402
from repro.core import behaviors as jb, engine as jeng  # noqa: E402
from repro.core import grid as jgrid  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import (CapacityExhausted, CapacityLadder,  # noqa: E402
                              DtypePolicy, EngineConfig, ForceParams,
                              LadderConfig, Simulation, SupervisedRunner,
                              health, restore_state, save_state, simcheck)
from repro_torch.core import behaviors as tb, grid as tgrid  # noqa: E402
from repro_torch.launch import simulate as tlaunch  # noqa: E402
from repro_torch.train import checkpoint  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")


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
# train/checkpoint.py corner cases
# ---------------------------------------------------------------------------

def test_gc_keep_window_exact(tmp_path):
    ck = checkpoint.AsyncCheckpointer(str(tmp_path), keep=3)
    tree = {"w": torch.arange(4, dtype=torch.float32)}
    for s in range(1, 9):
        ck.save_async(s, tree)
    ck.wait()
    assert checkpoint.list_steps(str(tmp_path)) == [6, 7, 8]
    for s in (6, 7, 8):
        out = checkpoint.restore(str(tmp_path), s, {"w": torch.zeros(4)})
        assert torch.equal(out["w"], torch.arange(4, dtype=torch.float32))


def test_stale_tmp_dir_is_harmless_and_collected(tmp_path):
    d = str(tmp_path)
    checkpoint.save(d, 1, {"a": torch.ones(2)})
    stale = os.path.join(d, "step_000000002.tmp")
    os.makedirs(stale)
    with open(os.path.join(stale, "arrays.npz"), "w") as f:
        f.write("partial garbage")
    assert checkpoint.list_steps(d) == [1]
    assert checkpoint.latest_step(d) == 1
    checkpoint.save(d, 2, {"a": torch.full((2,), 5.0)})
    assert checkpoint.latest_step(d) == 2
    out = checkpoint.restore(d, 2, {"a": torch.zeros(2)})
    assert torch.equal(out["a"], torch.full((2,), 5.0))
    ck = checkpoint.AsyncCheckpointer(d, keep=2)
    ck.save_async(3, {"a": torch.ones(2)})
    ck.wait()
    assert [n for n in os.listdir(d) if n.endswith(".tmp")] == []


def test_latest_step_survives_crash_before_latest_update(tmp_path):
    d = str(tmp_path)
    checkpoint.save(d, 4, {"a": torch.ones(2)})
    checkpoint.save(d, 9, {"a": torch.ones(2)})
    with open(os.path.join(d, "LATEST"), "w") as f:
        f.write("4")
    assert checkpoint.latest_step(d) == 9


def test_structure_mismatch_message_names_keys(tmp_path):
    d = str(tmp_path)
    checkpoint.save(d, 1, {"present": torch.ones(3), "both": torch.ones(1)})
    with pytest.raises(ValueError, match="structure mismatch") as e:
        checkpoint.restore(d, 1, {"wanted": torch.ones(3),
                                  "both": torch.ones(1)})
    msg = str(e.value)
    assert "wanted" in msg and "present" in msg
    assert "'both'" not in msg


def test_restore_shape_mismatch_names_key(tmp_path):
    d = str(tmp_path)
    checkpoint.save(d, 1, {"a": torch.ones((2, 3))})
    with pytest.raises(ValueError, match="a"):
        checkpoint.restore(d, 1, {"a": torch.ones((3, 2))})


def test_manifest_extras_roundtrip(tmp_path):
    d = str(tmp_path)
    extras = {"kind": "engine", "knobs": {"capacity": 128, "dt": 0.25}}
    checkpoint.save(d, 3, {"a": torch.ones(2)}, extras=extras)
    man = checkpoint.load_manifest(d, 3)
    assert man["step"] == 3
    assert man["extras"] == json.loads(json.dumps(extras))
    ck = checkpoint.AsyncCheckpointer(d, keep=2)
    ck.save_async(4, {"a": torch.ones(2)}, extras={"kind": "dist"})
    ck.wait()
    assert checkpoint.load_manifest(d, 4)["extras"] == {"kind": "dist"}


def test_bfloat16_leaves_are_stored_as_uint16_bits(tmp_path):
    import ml_dtypes
    d = str(tmp_path)
    x = torch.tensor([1.5, -2.25, 3e-3, 7.0], dtype=torch.bfloat16)
    checkpoint.save(d, 1, {"x": x, "h": x.to(torch.float16)})
    man = checkpoint.load_manifest(d, 1)
    assert man["leaves"]["x"]["dtype"] == "bfloat16"
    assert man["leaves"]["h"]["dtype"] == "float16"
    with np.load(os.path.join(d, "step_000000001", "arrays.npz")) as raw:
        assert raw["x"].dtype == np.uint16
    out = checkpoint.restore(d, 1, {"x": torch.zeros(4, dtype=torch.bfloat16),
                                    "h": torch.zeros(4, dtype=torch.float16)})
    assert out["x"].dtype == torch.bfloat16 and torch.equal(out["x"], x)
    # the reference reads the same file back as ml_dtypes bfloat16
    ref = jckpt.restore(d, 1, {"x": jnp.zeros(4, jnp.bfloat16),
                               "h": jnp.zeros(4, jnp.float16)})
    assert np.asarray(ref["x"]).dtype == ml_dtypes.bfloat16
    np.testing.assert_array_equal(
        np.asarray(ref["x"]).view(np.uint16),
        x.view(torch.int16).numpy().view(np.uint16))


# ---------------------------------------------------------------------------
# the reference's key strings, manifest and arrays
# ---------------------------------------------------------------------------

def _cfgs(**kw):
    base = dict(capacity=64, domain_lo=(0, 0, 0), domain_hi=(32, 32, 32),
                interaction_radius=2.0, dt=0.1, max_per_box=32,
                query_chunk=64)
    base.update(kw)
    jkw, tkw = dict(base), dict(base)
    from repro.core import ForceParams as JForce
    jkw["force"] = JForce(max_displacement=0.5)
    tkw["force"] = ForceParams(max_displacement=0.5)
    for key, jmod, tmod in (("rebuild", jgrid.RebuildPolicy,
                             tgrid.RebuildPolicy),
                            ("pairlist", jgrid.PairListConfig,
                             tgrid.PairListConfig)):
        if key in base:
            jkw[key] = jmod(**base[key])
            tkw[key] = tmod(**base[key])
    if "dtypes" in base:
        from repro.core import DtypePolicy as JPolicy
        jkw["dtypes"] = JPolicy(**base["dtypes"])
        tkw["dtypes"] = DtypePolicy(**base["dtypes"])
    # the reference's default "xla" is the port's streamed sweep
    tkw["force_impl"] = {"pallas": "k1"}.get(base.get("force_impl"),
                                             "streamed")
    return jeng.EngineConfig(**jkw), EngineConfig(**tkw)


def _pos(n=20, seed=0):
    return np.random.default_rng(seed).uniform(2, 30, (n, 3)).astype(
        np.float32)


def _jstate_leaves(st):
    """np.asarray on each leaf of a reference EngineState, as convert
    reads it."""
    env = None
    if st.env is not None:
        g = st.env.grid
        env = {"grid": {f: np.asarray(getattr(g, f)) for f in
                        ("origin", "box_size", "keys", "order", "rank",
                         "starts", "counts", "max_count", "max_run_count")},
               **{f: np.asarray(getattr(st.env, f))
                  for f in ("steps_since", "disp_accum", "dirty")},
               "pairs": None if st.env.pairs is None else {
                   f: np.asarray(getattr(st.env.pairs, f))
                   for f in ("idx", "run_off", "count", "demand")},
               "pair_disp": None if st.env.pair_disp is None
               else np.asarray(st.env.pair_disp)}
    return {"pool": {k: np.asarray(v) for k, v in st.pool.channels().items()},
            "rng": np.asarray(st.rng), "iteration": np.asarray(st.iteration),
            "stats": {f: np.asarray(st.stats[f]) for f in st.stats.keys()},
            "conc": np.asarray(st.conc), "env": env}


_SETUPS = {
    "plain": dict(),
    "every_k": dict(rebuild=dict(mode="every_k", k=4,
                                 displacement_bound=0.5)),
    "lean_k1": dict(dtypes=dict(aux_float="bfloat16", compact_ints=True),
                    force_impl="pallas"),
}


def _beh(mod):
    return [mod.GrowDivide(rate=0.5, threshold_diameter=3.0),
            mod.RandomWalk(sigma=0.2),
            mod.Infection(radius=2.0, beta=0.5, recovery_time=5)]


def _ref_run(setup, steps=5):
    jcfg, tcfg = _cfgs(**_SETUPS[setup])
    jsim = jeng.Simulation(jcfg, _beh(jb))
    types = np.zeros(20, np.int32)
    types[:3] = jb.INFECTED
    st = jsim.run(jsim.init_state(_pos(), diameter=np.full(20, 2.0,
                                                           np.float32),
                                  agent_type=types, seed=7), steps)
    return jcfg, tcfg, jsim, st


@pytest.mark.parametrize("setup", sorted(_SETUPS))
def test_port_writes_the_reference_format(setup, tmp_path):
    """The port's checkpoint of a state carried over from the reference
    holds the reference's key strings, manifest and arrays."""
    jcfg, tcfg, _, jst = _ref_run(setup)
    tst = convert.state_from_numpy(_jstate_leaves(jst), "cpu")
    jsimcheck.save_state(str(tmp_path / "ref"), jst, jcfg)
    save_state(str(tmp_path / "port"), tst, tcfg)
    step = int(jst.iteration)
    name = f"step_{step:09d}"
    jman = checkpoint.load_manifest(str(tmp_path / "ref"), step)
    tman = checkpoint.load_manifest(str(tmp_path / "port"), step)
    assert list(tman["leaves"]) == list(jman["leaves"])
    assert tman == jman
    assert set(checkpoint._flatten_with_paths(simcheck._stored(tst))) == \
        set(jckpt._flatten_with_paths(jst))
    with np.load(tmp_path / "ref" / name / "arrays.npz") as a, \
            np.load(tmp_path / "port" / name / "arrays.npz") as b:
        assert a.files == b.files
        for k in a.files:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("setup", sorted(_SETUPS))
def test_reference_checkpoint_restores_into_the_port_and_steps(setup,
                                                              tmp_path):
    jcfg, tcfg, jsim, jst = _ref_run(setup)
    jsimcheck.save_state(str(tmp_path), jst, jcfg)
    tst, cfg2 = restore_state(str(tmp_path), tcfg, _beh(tb), device="cpu")
    assert cfg2 == tcfg
    want = _jstate_leaves(jst)
    got = convert.state_to_numpy(tst)
    for k, w in want["pool"].items():
        g = got["pool"][k]
        np.testing.assert_array_equal(
            g, w.view(np.uint16) if w.dtype.name == "bfloat16" else w,
            err_msg=k)
    # one step each side: integers exact, floats 1e-4
    jnext = _jstate_leaves(jsim.step(jst))
    tnext = convert.state_to_numpy(Simulation(cfg2, _beh(tb),
                                              device="cpu").step(tst))
    for k, w in jnext["pool"].items():
        g = tnext["pool"][k]
        if w.dtype.name == "bfloat16":
            g = torch.from_numpy(g.view(np.int16)).view(
                torch.bfloat16).float().numpy()
            w = w.astype(np.float32)
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, atol=1e-4, rtol=1e-4, err_msg=k)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)
    for f, w in jnext["stats"].items():
        assert int(tnext["stats"][f]) == int(w), f


@pytest.mark.parametrize("setup", sorted(_SETUPS))
def test_port_checkpoint_restores_into_the_reference(setup, tmp_path):
    jcfg, tcfg = _cfgs(**_SETUPS[setup])
    sim = Simulation(tcfg, _beh(tb), device="cpu")
    types = np.zeros(20, np.int32)
    types[:3] = tb.INFECTED
    tst = sim.run(sim.init_state(_pos(), diameter=np.full(20, 2.0,
                                                          np.float32),
                                 agent_type=types, seed=7), 5)
    save_state(str(tmp_path), tst, tcfg)
    jst, jcfg2 = jsimcheck.restore_state(str(tmp_path), jcfg, _beh(jb))
    assert jcfg2 == jcfg
    want = convert.state_to_numpy(tst)
    got = _jstate_leaves(jst)
    for k, g in got["pool"].items():
        w = want["pool"][k]
        g = g.view(np.uint16) if g.dtype.name == "bfloat16" else g
        np.testing.assert_array_equal(g, w, err_msg=k)
    np.testing.assert_array_equal(got["rng"], want["rng"])
    jeng.Simulation(jcfg2, _beh(jb)).step(jst)          # steppable


# ---------------------------------------------------------------------------
# simcheck: save/restore, degradation, the supervisor
# ---------------------------------------------------------------------------

def _cfg(**kw):
    base = dict(capacity=64, domain_lo=(0, 0, 0), domain_hi=(32, 32, 32),
                interaction_radius=2.0, dt=0.1, max_per_box=32,
                query_chunk=64, force=ForceParams(max_displacement=0.5))
    base.update(kw)
    return EngineConfig(**base)


def _same(a, b) -> bool:
    la, lb = checkpoint._flatten_with_paths(a), \
        checkpoint._flatten_with_paths(b)
    if la.keys() != lb.keys():
        return False
    for k in la:
        x, y = la[k], lb[k]
        if isinstance(x, torch.Tensor):
            if not (x.dtype == y.dtype and torch.equal(x, y)):
                return False
        elif x != y:
            return False
    return True


@pytest.mark.parametrize("force_impl", ["k1", "streamed"])
def test_simcheck_roundtrip_bit_exact(force_impl, tmp_path):
    cfg = _cfg(force_impl=force_impl)
    sim = Simulation(cfg, [tb.RandomWalk(sigma=0.2)], device="cpu")
    st = sim.run(sim.init_state(_pos(), seed=7), 5)
    save_state(str(tmp_path), st, cfg)
    st2, cfg2 = restore_state(str(tmp_path), cfg, [tb.RandomWalk(sigma=0.2)],
                              device="cpu")
    assert cfg2 == cfg
    assert _same(st, st2)
    a = sim.run(st, 6)
    b = Simulation(cfg2, [tb.RandomWalk(sigma=0.2)], device="cpu").run(st2, 6)
    assert _same(a, b), "resume must be bit-exact"


@pytest.mark.parametrize("pairlist", [False, True])
def test_simcheck_roundtrip_every_k_cache(pairlist, tmp_path):
    kw = dict(rebuild=tgrid.RebuildPolicy(mode="every_k", k=4,
                                          displacement_bound=0.5))
    if pairlist:
        kw["pairlist"] = tgrid.PairListConfig(skin=0.8, max_pairs=32)
    cfg = _cfg(**kw)
    beh = lambda: [tb.RandomWalk(sigma=0.05)]
    sim = Simulation(cfg, beh(), device="cpu")
    st = sim.run(sim.init_state(_pos(), seed=3), 6)
    save_state(str(tmp_path), st, cfg)
    st2, cfg2 = restore_state(str(tmp_path), cfg, beh(), device="cpu")
    assert st2.env is not None
    assert (st2.env.pairs is not None) == pairlist
    assert int(st2.env.steps_since) == int(st.env.steps_since)
    assert _same(st, st2)
    a = sim.run(st, 7)
    b = Simulation(cfg2, beh(), device="cpu").run(st2, 7)
    assert _same(a, b)
    assert int(a.stats["rebuild_skips"]) == int(b.stats["rebuild_skips"])


def test_restore_adapts_env_across_rebuild_modes(tmp_path):
    cfg = _cfg(rebuild=tgrid.RebuildPolicy(mode="every_k", k=4,
                                           displacement_bound=0.5))
    sim = Simulation(cfg, [], device="cpu")
    st = sim.run(sim.init_state(_pos()), 3)
    save_state(str(tmp_path), st, cfg)
    st2, cfg2 = restore_state(str(tmp_path), _cfg(), [], apply_knobs="rungs",
                              device="cpu")
    assert cfg2.rebuild.mode == "every_step" and st2.env is None
    Simulation(cfg2, [], device="cpu").run(st2, 2)
    # and the other way: an every_step checkpoint into an every_k target
    # gets a dirty initial cache
    d2 = str(tmp_path / "b")
    save_state(d2, st2, cfg2)
    st3, cfg3 = restore_state(d2, cfg, [], apply_knobs="rungs", device="cpu")
    assert cfg3.rebuild.mode == "every_k" and bool(st3.env.dirty)
    Simulation(cfg3, [], device="cpu").run(st3, 2)


def test_restore_rejects_non_sim_checkpoint(tmp_path):
    checkpoint.save(str(tmp_path), 1, {"a": torch.ones(3)})
    with pytest.raises(ValueError, match="not a simulation checkpoint"):
        restore_state(str(tmp_path), _cfg(), [], device="cpu")
    with pytest.raises(FileNotFoundError):
        restore_state(str(tmp_path / "none"), _cfg(), [], device="cpu")


def test_degradation_policy_order_matches_reference():
    jcfg, tcfg = _cfgs(rebuild=dict(mode="every_k", k=4,
                                    displacement_bound=0.5),
                       force_impl="pallas")
    names = {}
    for mod, cfg in ((jsimcheck, jcfg), (simcheck, tcfg)):
        pol = mod.DegradationPolicy(max_dt_shrinks=2)
        applied = []
        while True:
            r = pol.next_remedy(cfg, applied)
            if r is None:
                break
            name, cfg = r
            applied.append(name)
        names[mod] = applied
        assert cfg.rebuild.mode == "every_step"
        assert not cfg.fused_sweep and cfg.force_impl == "xla"
        assert abs(cfg.dt - 0.1 * 0.25) < 1e-9
    assert names[simcheck] == names[jsimcheck] == [
        "rebuild_every_step", "sequential_sweep", "shrink_dt", "shrink_dt"]


def test_supervisor_nan_rollback_and_degradation(tmp_path):
    cfg = _cfg(force_impl="streamed")
    pos = _pos()
    clean = CapacityLadder(cfg, [], device="cpu")
    oracle = clean.run(clean.init_state(pos, seed=7), 12)
    fired = []

    def hook(it, state):
        if it == 6 and not fired:
            fired.append(it)
            return health.inject_value(state, "position", 3, np.nan)
        return None

    lad = CapacityLadder(cfg, [], device="cpu")
    runner = SupervisedRunner(lad, str(tmp_path), checkpoint_every=5,
                              fault_hook=hook)
    final, report = runner.run(lad.init_state(pos, seed=7), 12)
    assert report.completed and report.final_iteration == 12
    assert report.retries == 1
    [iv] = report.interventions
    assert iv["kind"] == "health" and "nonfinite" in iv["flags"]
    assert iv["remedy"] == "sequential_sweep"
    assert iv["rolled_back_to"] == 5
    assert lad.config.force_impl == "xla" and not lad.config.fused_sweep
    # the sequential sweep gives what the fused sweep gave, bit for bit
    assert _same(oracle.pool, final.pool)
    assert int(final.iteration) == int(oracle.iteration)


def test_supervisor_reraises_with_report_when_remedies_exhausted(tmp_path):
    cfg = _cfg(fused_sweep=False, force_impl="streamed")

    def hook(it, state):
        return health.inject_value(state, "position", 1, np.nan)

    lad = CapacityLadder(cfg, [], device="cpu")
    runner = SupervisedRunner(
        lad, str(tmp_path), checkpoint_every=5,
        policy=simcheck.DegradationPolicy(max_dt_shrinks=1), fault_hook=hook)
    with pytest.raises(health.HealthFault) as e:
        runner.run(lad.init_state(_pos(), seed=7), 12)
    rep = e.value.report
    assert rep is not None and not rep.completed
    assert [iv["remedy"] for iv in rep.interventions] == ["shrink_dt"]


def _exhaust_cfg(mod, force):
    return mod.EngineConfig(capacity=32, domain_lo=(0, 0, 0),
                            domain_hi=(64, 64, 64), interaction_radius=6.0,
                            max_per_box=64, dt=0.2,
                            force=force(max_displacement=1.0))


def _exhaust_seeds():
    return (np.random.default_rng(1).uniform(20, 44, (30, 3)).astype(
        np.float32), np.full(30, 3.0, np.float32))


def test_capacity_exhausted_carries_state():
    import repro_torch.core as tcore
    from repro.core import ForceParams as JForce
    pos, dia = _exhaust_seeds()
    jlad = jeng.CapacityLadder(_exhaust_cfg(jeng, JForce),
                               [jb.GrowDivide(rate=3.0,
                                              threshold_diameter=5.0)],
                               jeng.LadderConfig(max_capacity=48))
    with pytest.raises(jeng.CapacityExhausted) as je:
        jlad.run(jlad.init_state(pos, diameter=dia), 60)
    lad = CapacityLadder(_exhaust_cfg(tcore, ForceParams),
                         [tb.GrowDivide(rate=3.0, threshold_diameter=5.0)],
                         LadderConfig(max_capacity=48), device="cpu")
    with pytest.raises(CapacityExhausted, match="ladder exhausted") as e:
        lad.run(lad.init_state(pos, diameter=dia), 60)
    exc = e.value
    assert isinstance(exc, RuntimeError)
    assert exc.state is not None and exc.stats is not None
    assert exc.iteration == int(exc.state.iteration) == je.value.iteration
    assert exc.demand > exc.max_capacity == 48
    assert (exc.demand, exc.rung) == (je.value.demand, je.value.rung)
    assert int(exc.state.stats["n_live"]) > 0


def test_supervisor_capacity_exhaustion_emergency_checkpoint(tmp_path):
    import repro_torch.core as tcore
    pos, dia = _exhaust_seeds()
    lad = CapacityLadder(_exhaust_cfg(tcore, ForceParams),
                         [tb.GrowDivide(rate=3.0, threshold_diameter=5.0)],
                         LadderConfig(max_capacity=48), device="cpu")
    runner = SupervisedRunner(lad, str(tmp_path), checkpoint_every=50,
                              max_retries=2)
    with pytest.raises(CapacityExhausted) as e:
        runner.run(lad.init_state(pos, diameter=dia), 60)
    rep = e.value.report
    assert rep.retries > 0
    assert any(iv["kind"] == "capacity_exhausted"
               for iv in rep.interventions)
    last = checkpoint.latest_step(str(tmp_path))
    assert last is not None and last > 0 and last in rep.checkpoints


def test_run_supervised_wraps_a_ladder(tmp_path):
    cfg = _cfg(capacity=32, dt=1.0)
    sim = Simulation(cfg, [tb.GrowDivide(rate=1.0, threshold_diameter=3.0)],
                     device="cpu")
    st = sim.init_state(_pos(), diameter=np.full(20, 2.0, np.float32))
    final, report = sim.run_supervised(st, 6, str(tmp_path),
                                       checkpoint_every=3)
    assert report.completed and report.final_iteration == 6
    assert report.checkpoints == [0, 3, 6]
    assert any(r["field"] == "capacity" for r in report.rungs)
    assert int(final.stats["n_live"]) > 32


def test_ensemble_and_distributed_variants_name_their_items(tmp_path):
    # the ensemble variants are ported (tests/test_torch_ensemble.py and
    # test_torch_sim_service.py hold their round trips), and so are the
    # distributed ones (tests/test_torch_distributed_ladder.py holds their
    # resume, reshard and supervisor cases): a 2-shard every_k state
    # written with its knobs restores leaf for leaf
    from repro_torch.core import DistConfig, DistributedSimulation
    cfg = _cfg(rebuild=tgrid.RebuildPolicy("every_k", k=3,
                                           displacement_bound=0.5))
    dcfg = DistConfig(engine=cfg, n_shards=2, local_capacity=32,
                      halo_capacity=16, migrate_capacity=8)
    dsim = DistributedSimulation(dcfg, [tb.RandomWalk(sigma=0.3)],
                                 device="cpu")
    st = dsim.run(dsim.init_state(_pos(), diameter=np.full(20, 1.5,
                                                           np.float32)), 3)
    simcheck.save_dist_state(str(tmp_path), st, dcfg)
    manifest = checkpoint.load_manifest(str(tmp_path), 3)["extras"]
    assert manifest["kind"] == "dist"
    assert manifest["knobs"]["n_shards"] == 2
    got, rcfg = simcheck.restore_dist_state(
        str(tmp_path), dcfg, [tb.RandomWalk(sigma=0.3)], device="cpu")
    assert rcfg == dcfg and int(got.iteration) == 3
    for k, v in st.channels.items():
        assert torch.equal(got.channels[k], v), k
    for a, b in ((got.rng, st.rng), (got.boundaries, st.boundaries),
                 (got.env.grid.order, st.env.grid.order),
                 (got.env.grid.keys, st.env.grid.keys),
                 (got.env.dirty, st.env.dirty)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# crash-resume: SIGKILL mid-flight, resume bit-exact (child processes with
# no JAX)
# ---------------------------------------------------------------------------

_CRASH_SCRIPT = textwrap.dedent("""
    import hashlib, os, signal, sys
    import numpy as np
    import torch
    torch.set_num_threads(1)
    from repro_torch.core import (CapacityLadder, EngineConfig, ForceParams,
                                  SupervisedRunner, restore_state)
    from repro_torch.core.behaviors import (GrowDivide, RandomDeath,
                                            RandomWalk)

    mode, ckpt = sys.argv[1], sys.argv[2]
    TOTAL, KILL_AT = 40, 23

    def make():
        cfg = EngineConfig(capacity=256, domain_lo=(0, 0, 0),
                           domain_hi=(160, 160, 160),
                           interaction_radius=14.0, dt=0.2,
                           sort_frequency=10, max_per_box=160,
                           force=ForceParams(max_displacement=1.0))
        behs = [GrowDivide(rate=0.7, threshold_diameter=12.0),
                RandomWalk(sigma=0.1), RandomDeath(rate=0.012)]
        return cfg, behs

    def digest(state):
        a = state.pool.alive.numpy()
        p = state.pool.position.numpy()[a]
        p = p[np.lexsort(p.T)]
        return hashlib.sha256(p.tobytes()).hexdigest()

    rng = np.random.default_rng(3)
    pos = rng.uniform(55, 105, (200, 3)).astype(np.float32)
    dia = np.full(200, 9.0, np.float32)
    cfg, behs = make()

    if mode == "oracle":
        lad = CapacityLadder(cfg, behs, device="cpu")
        st = lad.run(lad.init_state(pos, diameter=dia), TOTAL)
        print("RESULT " + digest(st) + " " + str(int(st.iteration)))
    elif mode == "kill":
        def hook(it, state):
            if it == KILL_AT:
                os.kill(os.getpid(), signal.SIGKILL)
            return None
        lad = CapacityLadder(cfg, behs, device="cpu")
        runner = SupervisedRunner(lad, ckpt, checkpoint_every=5,
                                  fault_hook=hook)
        runner.run(lad.init_state(pos, diameter=dia), TOTAL)
        print("RESULT survived")
    elif mode == "resume":
        st, rcfg = restore_state(ckpt, cfg, behs, device="cpu")
        lad = CapacityLadder(rcfg, behs, device="cpu")
        runner = SupervisedRunner(lad, ckpt, checkpoint_every=5)
        st, report = runner.run(st, TOTAL - int(st.iteration))
        assert report.completed, report
        print("RESULT " + digest(st) + " " + str(int(st.iteration)))
    print("JAX_LOADED", "jax" in sys.modules)
""")


def _child(args, script=_CRASH_SCRIPT, timeout=600):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    cmd = [sys.executable, "-c", script] if script else [sys.executable]
    return subprocess.run(cmd + args, env=env, capture_output=True,
                          text=True, timeout=timeout)


def _result(proc):
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "JAX_LOADED False" in proc.stdout
    return [l for l in proc.stdout.splitlines()
            if l.startswith("RESULT ")][-1][len("RESULT "):]


def test_sigkill_ladder_run_resumes_bit_exact(tmp_path):
    ckpt = str(tmp_path / "ck")
    killed = _child(["kill", ckpt])
    assert killed.returncode == -signal.SIGKILL, killed.stderr[-2000:]
    assert "RESULT survived" not in killed.stdout
    assert checkpoint.latest_step(ckpt) == 20
    resumed = _result(_child(["resume", ckpt]))
    oracle = _result(_child(["oracle", str(tmp_path / "unused")]))
    assert resumed == oracle


def _cli(args):
    return _child(["-m", "repro_torch.launch.simulate", "--device", "cpu",
                   "--scenario", "oncology", "--agents", "64"] + args,
                  script=None)


def test_cli_supervised_resume_equals_uninterrupted(tmp_path):
    """The CLI's --supervised/--resume path: 6 steps, then --resume for 4
    more, against 10 uninterrupted steps (digest of the live state)."""
    with pytest.raises(SystemExit, match="require --ckpt-dir"):
        tlaunch.main(["--supervised", "--device", "cpu"])
    full = _cli(["--iterations", "10", "--supervised", "--ckpt-dir",
                 str(tmp_path / "a"), "--checkpoint-every", "5"])
    assert full.returncode == 0, full.stderr[-3000:]
    line = [l for l in full.stdout.splitlines()
            if l.startswith("run report: ")][-1]
    report = json.loads(line[len("run report: "):])
    assert report["completed"] and report["final_iteration"] == 10
    assert report["checkpoints"] == [0, 5, 10]
    part = _cli(["--iterations", "6", "--supervised", "--ckpt-dir",
                 str(tmp_path / "b"), "--checkpoint-every", "3"])
    assert part.returncode == 0, part.stderr[-3000:]
    res = _cli(["--iterations", "4", "--resume", "--ckpt-dir",
                str(tmp_path / "b"), "--checkpoint-every", "3"])
    assert res.returncode == 0, res.stderr[-3000:]
    assert "resumed from" in res.stdout and "at iteration 6" in res.stdout
    a, _ = restore_state(str(tmp_path / "a"), _onc_cfg(), _onc_beh(),
                         device="cpu")
    b, _ = restore_state(str(tmp_path / "b"), _onc_cfg(), _onc_beh(),
                         device="cpu")
    assert int(a.iteration) == int(b.iteration) == 10
    assert _same(a, b)


def _onc_cfg():
    return tlaunch.build("oncology", 64, device="cpu")[0].config


def _onc_beh():
    return tlaunch.build("oncology", 64, device="cpu")[0].behaviors

