"""The distributed capacity ladder, distributed checkpoints and the
supervisor over 4 shards stacked as lanes on one device (CPU, plain
kernels).

* tests/test_ladder.py's distributed ladder: agreed global rungs, a rewind
  from the pre-step state, the trajectory ≡ a run pre-sized at the final
  rungs bit for bit;
* tests/test_pairlist.py's 4-shard contract: the streamed sweep ≡ a skin-0
  pair list (integers exact, floats to the reference's 1e-5), and the
  ``max_pairs`` rung ≡ the pre-sized run bit for bit;
* tests/test_fault_tolerance.py's distributed cases: a supervised run
  stopped mid-flight resumes from its checkpoint bit-exact, a 4-shard
  checkpoint restores onto 2 shards with its population, and a NaN
  injected into a shard is rolled back and recovered invisibly;
* a restore onto a larger ``local_capacity`` re-packs every slab.
"""

import dataclasses
import hashlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import (DistConfig, DistributedCapacityLadder,  # noqa
                              DistributedSimulation, EngineConfig,
                              ForceParams, LadderConfig, PairListConfig,
                              SupervisedRunner, health, restore_dist_state,
                              save_dist_state)
from repro_torch.core import behaviors as tb  # noqa: E402

CPU = "cpu"


@pytest.fixture(autouse=True)
def _single_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _canon(ch, *names):
    a = np.asarray(ch["alive"])
    p = np.asarray(ch["position"])[a]
    o = np.lexsort(p.T)
    return (p[o],) + tuple(np.asarray(ch[n])[a][o] for n in names)


def _channels(st):
    return {k: v.numpy() for k, v in st.channels.items()}


# ---------------------------------------------------------------------------
# tests/test_ladder.py: the distributed ladder ≡ pre-sized, bit for bit
# ---------------------------------------------------------------------------

class Drift(tb.Behavior):
    """Deterministic +x drift: forces agents across slab boundaries."""
    name = "drift"

    def __call__(self, ctx, pool, rng):
        step = torch.tensor([1.0, 0.0, 0.0]) * ctx.dt
        new_pos = torch.where(ctx.owned[:, None], pool.position + step,
                              pool.position)
        new_pos = torch.clamp(new_pos, ctx.domain_lo, ctx.domain_hi)
        return tb.BehaviorEffects(set_channels={"position": new_pos})


def test_distributed_ladder_bit_parity():
    beh = lambda: [tb.GrowDivide(rate=0.8, threshold_diameter=6.0),  # noqa
                   Drift()]
    rng = np.random.default_rng(1)
    side, n0 = 64.0, 64
    cfg = EngineConfig(capacity=n0, domain_lo=(0, 0, 0),
                       domain_hi=(side,) * 3, interaction_radius=4.0, dt=1.0,
                       max_per_box=8, query_chunk=128,
                       force=ForceParams(max_displacement=0.5))
    pos = rng.uniform(2, side - 2, (n0, 3)).astype(np.float32)
    dia = np.full(n0, 5.2, np.float32)

    dl = DistributedCapacityLadder(
        DistConfig(engine=cfg, n_shards=4, local_capacity=48,
                   halo_capacity=24, migrate_capacity=12,
                   rebalance_frequency=3),
        beh(), LadderConfig(), device=CPU)
    st = dl.run(dl.init_state(pos, diameter=dia), 7)

    ds = DistributedSimulation(dl.dcfg, beh(), device=CPU)
    st2 = ds.run(ds.init_state(pos, diameter=dia), 7, check_overflow=True)
    (p1,), (p2,) = _canon(_channels(st)), _canon(_channels(st2))
    assert p1.shape[0] == p2.shape[0] > n0
    np.testing.assert_array_equal(p1, p2)
    assert "local_capacity" in {r["field"] for r in dl.rungs}, dl.rungs
    assert dl.recompiles >= 2
    assert int(st.stats.n_live.min()) > 0, "every slab holds agents"
    for k, v in st.channels.items():      # whole slabs, slot for slot
        assert torch.equal(v, st2.channels[k]), k


def test_ladder_refuses_to_grow_past_geometry():
    cfg = EngineConfig(capacity=64, domain_lo=(0, 0, 0),
                       domain_hi=(64.0,) * 3, interaction_radius=4.0)
    dl = DistributedCapacityLadder(DistConfig(engine=cfg, n_shards=4,
                                              local_capacity=64,
                                              halo_capacity=16,
                                              migrate_capacity=16),
                                   device=CPU)
    st = dl.init_state(np.zeros((4, 3), np.float32) + 30.0)
    stats = dataclasses.replace(st.stats, thin_slab=torch.tensor(
        [0, 1, 0, 0], dtype=torch.int32))
    with pytest.raises(RuntimeError, match="thin interior slab"):
        dl._diagnose(stats)
    stats = dataclasses.replace(st.stats, in_flight=torch.tensor(
        [0, 0, 2, 0], dtype=torch.int32))
    with pytest.raises(RuntimeError, match="in flight"):
        dl._diagnose(stats)


def test_init_grows_local_capacity_past_a_crowded_slab():
    """A population too big for a slab at init grows the rung (the ladder's
    init semantics) instead of raising SlabCapacityError."""
    cfg = EngineConfig(capacity=256, domain_lo=(0, 0, 0),
                       domain_hi=(32.0,) * 3, interaction_radius=2.0)
    pos = np.random.default_rng(0).uniform(1, 31, (200, 3)).astype(
        np.float32)
    pos[:, 0] = 7.0                    # every agent ties into one slab
    dl = DistributedCapacityLadder(
        DistConfig(engine=cfg, n_shards=4, local_capacity=64,
                   halo_capacity=16, migrate_capacity=16), device=CPU)
    st = dl.init_state(pos)
    assert dl.dcfg.local_capacity >= 200
    assert int(st.channels["alive"].sum()) == 200
    assert dl.rungs[0]["field"] == "local_capacity"


# ---------------------------------------------------------------------------
# tests/test_pairlist.py: 4 shards, the streamed sweep ≡ a skin-0 list, and
# the max_pairs rung ≡ pre-sized
# ---------------------------------------------------------------------------

def _pairlist_parts():
    side, n = 48.0, 1024
    rng = np.random.default_rng(7)
    pos = rng.uniform(2, side - 2, (n, 3)).astype(np.float32)
    types = np.zeros(n, np.int32)
    types[:32] = tb.INFECTED

    def cfg(pairlist=None):
        return EngineConfig(capacity=n, domain_lo=(0., 0., 0.),
                            domain_hi=(side,) * 3, interaction_radius=3.0,
                            max_per_box=32, query_chunk=256,
                            force_impl="streamed", pairlist=pairlist)

    def beh():
        # RandomWalk drives agents across slab boundaries: mid-run
        # migration exercises the dirty-on-structural-change conditions
        return [tb.RandomWalk(sigma=0.35),
                tb.Infection(radius=3.0, beta=0.4, recovery_time=8)]

    def dist(c):
        return DistConfig(engine=c, n_shards=4, local_capacity=2 * n // 4,
                          halo_capacity=256, migrate_capacity=256)

    def init(sim):
        return sim.init_state(pos, np.full(n, 2.5, np.float32), types,
                              extra_init={"infect_timer":
                                          np.full(n, 8, np.int32)})
    return cfg, beh, dist, init


def test_pairlist_four_shards_equal_streamed():
    cfg, beh, dist, init = _pairlist_parts()
    out = {}
    for pl in (None, PairListConfig(skin=0.0, max_pairs=96)):
        sim = DistributedSimulation(dist(cfg(pl)), beh(), device=CPU)
        st = init(sim)
        for _ in range(8):
            st = sim.step(st)
            assert not st.stats.flags(), st.stats.flags()
        out[pl is None] = _canon(sim.gather_channels(st), "agent_type")
    assert out[True][0].shape == out[False][0].shape
    assert np.abs(out[True][0] - out[False][0]).max() <= 1e-5
    np.testing.assert_array_equal(out[True][1], out[False][1])


def test_pairlist_max_pairs_rung_equals_presized():
    cfg, beh, dist, init = _pairlist_parts()
    lad = DistributedCapacityLadder(
        dist(cfg(PairListConfig(skin=0.0, max_pairs=2))), beh(), device=CPU)
    st = init(lad)
    for _ in range(4):
        st = lad.step(st)
    grown = lad.dcfg.engine.pairlist.max_pairs
    assert any(r["field"] == "max_pairs" for r in lad.rungs), lad.rungs
    pre = DistributedSimulation(
        dist(cfg(PairListConfig(skin=0.0, max_pairs=grown))), beh(),
        device=CPU)
    sp = init(pre)
    for _ in range(4):
        sp = pre.step(sp)
    la, pa = (_canon(lad.sim.gather_channels(st)),
              _canon(pre.gather_channels(sp)))
    assert la[0].shape == pa[0].shape
    np.testing.assert_array_equal(la[0], pa[0])


# ---------------------------------------------------------------------------
# tests/test_fault_tolerance.py: resume, reshard, supervised recovery
# ---------------------------------------------------------------------------

TOTAL, KILL_AT, SIDE = 16, 10, 48.0


def _ft_make(n_shards=4, local=256):
    cfg = EngineConfig(capacity=512, domain_lo=(0, 0, 0),
                       domain_hi=(SIDE,) * 3, interaction_radius=4.0,
                       dt=0.1, max_per_box=64, query_chunk=128,
                       force=ForceParams(max_displacement=0.5),
                       force_impl="streamed")
    return DistConfig(engine=cfg, n_shards=n_shards, local_capacity=local,
                      halo_capacity=128, migrate_capacity=64), \
        [tb.RandomWalk(sigma=0.3)]


def _ft_inputs():
    rng = np.random.default_rng(0)
    return (rng.uniform(2, SIDE - 2, (400, 3)).astype(np.float32),
            np.full(400, 3.0, np.float32))


def _digest(state):
    (p,) = _canon(_channels(state))
    return hashlib.sha256(p.tobytes()).hexdigest()


@pytest.fixture(scope="module")
def oracle():
    dcfg, behs = _ft_make()
    pos, dia = _ft_inputs()
    lad = DistributedCapacityLadder(dcfg, behs, device=CPU)
    st = lad.run(lad.init_state(pos, diameter=dia), TOTAL)
    return _digest(st), int(st.iteration)


class _Crash(Exception):
    """Stands for the process dying mid-run."""


def test_dist_stopped_run_resumes_bit_exact(tmp_path, oracle):
    ckpt = str(tmp_path / "ck")
    dcfg, behs = _ft_make()
    pos, dia = _ft_inputs()

    def hook(it, state):
        if it == KILL_AT:
            raise _Crash
        return None
    lad = DistributedCapacityLadder(dcfg, behs, device=CPU)
    runner = SupervisedRunner(lad, ckpt, checkpoint_every=4, fault_hook=hook)
    with pytest.raises(_Crash):
        runner.run(lad.init_state(pos, diameter=dia), TOTAL)
    runner._ckpt.wait()
    st, rcfg = restore_dist_state(ckpt, dcfg, behs, device=CPU)
    assert int(st.iteration) == 8 and st.iteration.device.type == "cpu"
    lad = DistributedCapacityLadder(rcfg, behs, device=CPU)
    runner = SupervisedRunner(lad, ckpt, checkpoint_every=4)
    st, report = runner.run(st, TOTAL - int(st.iteration))
    assert report.completed and report.checkpoints == [8, 12, 16]
    assert (_digest(st), int(st.iteration)) == oracle


def test_dist_restore_onto_different_shard_count(tmp_path):
    ckpt = str(tmp_path / "ck")
    dcfg, behs = _ft_make()
    pos, dia = _ft_inputs()
    dsim = DistributedSimulation(dcfg, behs, device=CPU)
    st = dsim.run(dsim.init_state(pos, diameter=dia), 5)
    save_dist_state(ckpt, st, dcfg)
    n_before = int(st.channels["alive"].sum())
    d2, _ = _ft_make(n_shards=2, local=512)
    st2, rcfg = restore_dist_state(ckpt, d2, behs, device=CPU)
    assert rcfg.n_shards == 2 and int(st2.iteration) == 5
    assert int(st2.channels["alive"].sum()) == n_before
    assert st2.rng.shape == (2, 2) and st2.boundaries.shape == (3,)
    out = DistributedSimulation(rcfg, behs, device=CPU).run(
        st2, 3, check_overflow=True)
    assert int(out.channels["alive"].sum()) == n_before
    with pytest.raises(ValueError, match="drops"):
        restore_dist_state(ckpt, _ft_make(n_shards=2, local=128)[0], behs,
                           device=CPU)


def test_dist_restore_onto_a_larger_rung_repacks(tmp_path):
    ckpt = str(tmp_path / "ck")
    dcfg, behs = _ft_make()
    pos, dia = _ft_inputs()
    dsim = DistributedSimulation(dcfg, behs, device=CPU)
    st = dsim.run(dsim.init_state(pos, diameter=dia), 3)
    save_dist_state(ckpt, st, dcfg)
    big = dataclasses.replace(dcfg, local_capacity=320)
    got, rcfg = restore_dist_state(ckpt, big, behs, device=CPU)
    assert rcfg.local_capacity == 320
    for k, v in st.channels.items():
        g = got.channels[k].reshape(4, 320, *v.shape[1:])
        assert torch.equal(g[:, :256], v.reshape(4, 256, *v.shape[1:])), k
        assert not g[:, 256:].any(), k
    assert _digest(got) == _digest(st)


def test_dist_nan_injection_supervised_recovery(tmp_path, oracle):
    dcfg, behs = _ft_make()
    pos, dia = _ft_inputs()
    fired = []

    def hook(it, state):
        if it == 6 and not fired:
            fired.append(it)
            return health.inject_value(state, "position", 3, float("nan"))
        return None
    lad = DistributedCapacityLadder(dcfg, behs, device=CPU)
    runner = SupervisedRunner(lad, str(tmp_path / "ck"), checkpoint_every=4,
                              fault_hook=hook)
    st, report = runner.run(lad.init_state(pos, diameter=dia), TOTAL)
    assert report.completed, report
    assert len(report.interventions) == 1, report.interventions
    iv = report.interventions[0]
    assert iv["kind"] == "health" and iv["remedy"] == "sequential_sweep"
    assert iv["rolled_back_to"] == 4
    assert lad.dcfg.engine.fused_sweep is False
    assert (_digest(st), int(st.iteration)) == oracle, \
        "recovery must be invisible"
