"""Simulation service: the port's continuous batching over ensemble lanes.

The corner cases of tests/test_sim_service.py in the port — admission into
a full pool queues and never drops, the all-idle tick launches nothing, a
request in a recycled lane gets a fresh RNG stream, a checkpoint taken
mid-churn resumes bit-exact — plus what crosses packages: the service's
results equal the reference service's on the same requests, and an
ensemble checkpoint written by either package restores in the other and
steps on.
"""

import collections

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import EngineConfig as JConfig  # noqa: E402
from repro.core import ScenarioParams as JParams  # noqa: E402
from repro.core import behaviors as jb  # noqa: E402
from repro.core import simcheck as jsimcheck  # noqa: E402
from repro.core.ensemble import EnsembleEngine as JEnsemble  # noqa: E402
from repro.serve import SimRequest as JRequest  # noqa: E402
from repro.serve import SimService as JService  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import (EngineConfig, EnsembleEngine,  # noqa: E402
                              ScenarioParams, restore_ensemble_state,
                              save_ensemble_state)
from repro_torch.core import behaviors as tb  # noqa: E402
from repro_torch.core import simcheck  # noqa: E402
from repro_torch.serve import SimRequest, SimService  # noqa: E402
from repro_torch.train import checkpoint  # noqa: E402

N = 96


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


_KW = dict(capacity=128, domain_lo=(0.0,) * 3, domain_hi=(48.0,) * 3,
           interaction_radius=3.0, use_forces=False, detect_static=False,
           query_chunk=1024, max_per_box=32)


def _behaviors(mod):
    return [mod.RandomWalk(sigma=0.8),
            mod.Infection(radius=3.0, beta=lambda ctx: ctx.params["beta"],
                          recovery_time=30)]


def _arrays(seed):
    r = np.random.RandomState(seed)
    pos = r.uniform(0, 48, (N, 3)).astype(np.float32)
    at = np.zeros((N,), np.int32)
    at[:8] = tb.INFECTED
    timer = np.zeros((N,), np.int32)
    timer[:8] = 30
    return pos, np.full((N,), 1.0, np.float32), at, timer


def _req(uid, seed, beta, max_steps=40, ref=False):
    pos, dia, at, timer = _arrays(seed)
    req, params = (JRequest, JParams) if ref else (SimRequest, ScenarioParams)
    return req(uid=uid, position=pos, diameter=dia, agent_type=at,
               extra_init={"infect_timer": timer}, seed=seed,
               params=params.of(beta=beta), max_steps=max_steps)


def _metrics(pool, params):
    return ((pool.agent_type == tb.INFECTED) & pool.alive).sum()


def _service(n_lanes=3):
    return SimService(EngineConfig(**_KW), _behaviors(tb), n_lanes=n_lanes,
                      params_template=ScenarioParams.of(beta=0.0),
                      metrics_fn=_metrics,
                      converged_fn=lambda m: int(m) == 0, device="cpu")


def _ref_service(n_lanes=3):
    return JService(JConfig(**_KW), _behaviors(jb), n_lanes=n_lanes,
                    params_template=JParams.of(beta=0.0),
                    metrics_fn=lambda pool, params: jnp.sum(
                        (pool.agent_type == jb.INFECTED) & pool.alive),
                    converged_fn=lambda m: int(m) == 0)


def test_full_pool_queues_never_drops():
    svc = _service(n_lanes=3)
    for u in range(6):
        svc.submit(_req(u, seed=100 + u, beta=0.2, max_steps=12))
    assert len(svc.queue) == 6
    # the first tick admits exactly n_lanes; the rest stays queued
    assert svc.step() == 3
    assert len(svc.queue) == 3
    assert svc.occupancy() == 1.0
    ticks = svc.run_until_drained()
    assert sorted(f.uid for f in svc.finished) == list(range(6))
    assert all(f.reason in ("converged", "max_steps") for f in svc.finished)
    assert all(len(f.trajectory) == f.steps for f in svc.finished)
    # 6 budget-12 simulations over 3 lanes take at least two waves
    assert 1 + ticks >= 24


def test_service_results_equal_the_reference_service():
    """The same requests through both services: each simulation retires
    at the same tick for the same reason with the same metric stream, and
    its final lane state matches (integers and keys exact, floats
    1e-4)."""
    svc, ref = _service(n_lanes=2), _ref_service(n_lanes=2)
    for u in range(4):
        svc.submit(_req(u, seed=40 + u, beta=0.15 + 0.1 * u, max_steps=10))
        ref.submit(_req(u, seed=40 + u, beta=0.15 + 0.1 * u, max_steps=10,
                        ref=True))
    assert svc.run_until_drained() == ref.run_until_drained()
    got = {f.uid: f for f in svc.finished}
    for w in ref.finished:
        g = got[w.uid]
        assert (g.lane, g.steps, g.reason) == (w.lane, w.steps, w.reason)
        assert [int(m) for m in g.trajectory] == \
            [int(np.asarray(m)) for m in w.trajectory]
        for name, jv in w.final.pool.channels().items():
            a, b = g.final.pool.channels()[name].numpy(), np.asarray(jv)
            if b.dtype.kind == "f":
                np.testing.assert_allclose(a, b, atol=1e-4, rtol=1e-4)
            else:
                np.testing.assert_array_equal(a, b, err_msg=name)
        np.testing.assert_array_equal(
            g.final.rng.numpy(), np.asarray(w.final.rng).astype(np.uint32))


class _CountOps(torch.utils._python_dispatch.TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[str(func)] += 1
        return func(*args, **(kwargs or {}))


def test_all_idle_tick_launches_nothing():
    svc = _service(n_lanes=2)
    with _CountOps() as mode:
        assert svc.step() == 0                   # nothing queued, all idle
    assert not mode.ops
    assert int(svc.state.tick) == 0
    svc.submit(_req(0, seed=5, beta=0.2, max_steps=3))
    svc.run_until_drained()
    tick_after = int(svc.state.tick)
    with _CountOps() as mode:
        assert svc.step() == 0                   # drained: idle again
    assert not mode.ops
    assert int(svc.state.tick) == tick_after


def test_lane_reuse_has_independent_rng_stream():
    """A request admitted into a recycled lane produces exactly what it
    would in a fresh service: the previous occupant's RNG stream, params
    and state leave nothing behind."""
    churned = _service(n_lanes=1)
    churned.submit(_req(0, seed=7, beta=0.3, max_steps=9))
    churned.submit(_req(1, seed=21, beta=0.45, max_steps=11))
    churned.run_until_drained()
    assert [f.uid for f in churned.finished] == [0, 1]
    reused = next(f for f in churned.finished if f.uid == 1)

    fresh = _service(n_lanes=1)
    fresh.submit(_req(1, seed=21, beta=0.45, max_steps=11))
    fresh.run_until_drained()
    alone = fresh.finished[0]

    assert reused.steps == alone.steps and reused.reason == alone.reason
    for name, av in reused.final.pool.channels().items():
        assert torch.equal(av, alone.final.pool.channels()[name]), name
    assert torch.equal(reused.final.rng, alone.final.rng)
    assert [int(m) for m in reused.trajectory] == \
        [int(m) for m in alone.trajectory]


def _same_state(a, b):
    for name, av in a.pool.channels().items():
        assert torch.equal(av, b.pool.channels()[name]), name
    for x, y in ((a.rng, b.rng), (a.active, b.active),
                 (a.iteration, b.iteration), (a.tick, b.tick)):
        assert torch.equal(x, y)


def test_checkpoint_resume_bit_exact_mid_churn(tmp_path):
    svc = _service(n_lanes=3)
    for u in range(5):
        svc.submit(_req(10 + u, seed=200 + u, beta=0.2 + 0.05 * u,
                        max_steps=8))
    for _ in range(10):
        svc.step()          # mid-churn: some retired, lanes reused
    assert svc.finished and any(i is not None for i in svc.lanes)

    finished_at_ckpt = sorted(f.uid for f in svc.finished)
    svc.checkpoint(str(tmp_path), extras={"finished_uids": finished_at_ckpt})
    table_at_ckpt = [None if i is None else i["req"].uid for i in svc.lanes]
    for _ in range(6):
        svc.step()          # the original goes on

    svc2 = _service(n_lanes=3)
    tick = svc2.restore(str(tmp_path))
    assert tick == int(svc2.state.tick)
    assert svc2.restored_meta["finished_uids"] == finished_at_ckpt
    assert [None if i is None else i["req"].uid
            for i in svc2.lanes] == table_at_ckpt
    for _ in range(6):
        svc2.step()         # the same 6 ticks again
    _same_state(svc.state, svc2.state)


def _ens_leaves(st):
    """np.asarray on each leaf of a reference EnsembleState."""
    return {"pool": {k: np.asarray(v) for k, v in st.pool.channels().items()},
            "conc": np.asarray(st.conc), "rng": np.asarray(st.rng),
            "iteration": np.asarray(st.iteration),
            "stats": {f: np.asarray(st.stats[f]) for f in st.stats.keys()},
            "active": np.asarray(st.active),
            "params": {"dt": None, "force": {},
                       "rates": {k: np.asarray(v)
                                 for k, v in st.params.rates.items()}},
            "tick": np.asarray(st.tick)}


def _churned(engine, params, ticks=5):
    st = engine.init_state()
    for lane, (sd, b) in enumerate([(3, 0.2), (8, 0.4), (9, 0.3)]):
        pos, dia, at, timer = _arrays(sd)
        st = engine.admit(st, lane, engine.stage_lane(
            pos, dia, at, {"infect_timer": timer}, seed=sd),
            params.of(beta=b))
    for _ in range(ticks):
        st = engine.step(st)
    return engine.retire(st, 1)


def _close(got, want, where):
    for name, w in want["pool"].items():
        g = got["pool"][name]
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, atol=1e-4, rtol=1e-4,
                                       err_msg=f"{where} {name}")
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"{where} {name}")
    for key in ("rng", "iteration", "active", "tick"):
        np.testing.assert_array_equal(got[key], want[key],
                                      err_msg=f"{where} {key}")


def test_ensemble_checkpoint_crosses_packages_both_ways(tmp_path):
    """A reference ensemble checkpoint restores into the port leaf for leaf
    and steps on as the reference does; a port checkpoint holds the
    reference's key strings and manifest, restores into the reference, and
    restored in the port steps on bit-exact with the uninterrupted run."""
    # the reference's default force path is its streamed sweep ("xla")
    jcfg, tcfg = JConfig(**_KW), EngineConfig(**_KW, force_impl="streamed")
    jeng = JEnsemble(jcfg, _behaviors(jb), 3, JParams.of(beta=0.0))
    teng = EnsembleEngine(tcfg, _behaviors(tb), 3,
                          ScenarioParams.of(beta=0.0), device="cpu")
    jst = _churned(jeng, JParams)
    tst = _churned(teng, ScenarioParams)

    # reference → port
    jsimcheck.save_ensemble_state(str(tmp_path / "ref"), jst, jcfg)
    got, cfg2, meta = restore_ensemble_state(
        str(tmp_path / "ref"), tcfg, _behaviors(tb),
        ScenarioParams.of(beta=0.0), device="cpu")
    assert cfg2 == tcfg and meta["n_lanes"] == 3
    want = _ens_leaves(jst)
    leaves = convert.ensemble_state_to_numpy(got)
    for name, w in want["pool"].items():
        np.testing.assert_array_equal(leaves["pool"][name], w, err_msg=name)
    for key in ("rng", "iteration", "active", "tick", "conc"):
        np.testing.assert_array_equal(leaves[key], want[key], err_msg=key)
    np.testing.assert_array_equal(leaves["params"]["rates"]["beta"],
                                  want["params"]["rates"]["beta"])
    for _ in range(3):
        got, jst = teng.step(got), jeng.step(jst)
    _close(convert.ensemble_state_to_numpy(got), _ens_leaves(jst),
           "ref→port stepped")

    # port → reference: the reference's keys and manifest
    save_ensemble_state(str(tmp_path / "port"), tst, tcfg)
    jsimcheck.save_ensemble_state(str(tmp_path / "ref2"),
                                  _churned(jeng, JParams), jcfg)
    tick = int(tst.tick)
    tman = checkpoint.load_manifest(str(tmp_path / "port"), tick)
    jman = jckpt.load_manifest(str(tmp_path / "ref2"), tick)
    assert tman == jman
    jback, _, _ = jsimcheck.restore_ensemble_state(
        str(tmp_path / "port"), jcfg, _behaviors(jb), JParams.of(beta=0.0))
    _close(_ens_leaves(jback), convert.ensemble_state_to_numpy(tst),
           "port→ref")
    np.testing.assert_array_equal(
        np.asarray(jback.pool.position),
        convert.ensemble_state_to_numpy(tst)["pool"]["position"])
    jeng.step(jback)                                   # steppable

    # and the port's own restore steps on bit-exact
    back, _, _ = simcheck.restore_ensemble_state(
        str(tmp_path / "port"), tcfg, _behaviors(tb),
        ScenarioParams.of(beta=0.0), device="cpu")
    for _ in range(3):
        back, tst = teng.step(back), teng.step(tst)
    _same_state(back, tst)
