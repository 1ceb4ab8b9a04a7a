"""The distributed engine: the port's shards, stacked as lanes on one
device, ≡ the port's solo runs ≡ the reference's ``DistributedSimulation``.

* the host helpers (``quantile_boundaries``, ``partition_global``,
  ``pack_channels``) and ``rand.fold_in`` ≡ the reference's, in process,
  integers exact;
* tests/test_distributed.py's three cases on 4 shards ≡ the port's solo
  ``Simulation`` with the reference's bounds: forces only, SIR with births,
  deaths, migration and rebalance, and sharded diffusion with secretion
  (n_live equal, positions < 1e-3, types and extras exact, the grid within
  1e-4 of its scale); the sharded FTCS step ≡ the full-grid step bit for
  bit;
* the SIR case ≡ the reference's 4-shard run on the same inputs (one
  module-scoped subprocess with 4 host devices, as the reference's own
  test runs it): integers, stats and per-shard n_live equal, positions
  within 1e-3, boundaries within 1e-4; a checkpoint written by either
  package restores in the other, whose next step is the writer's; the
  same assertions hold for the port on 4 gloo ranks of one shard each
  (``launch/distributed.py``), and the reference's checkpoint restored
  onto those ranks steps as the reference's;
* tests/test_fused.py's 4-shard contract (fused ≡ sequential, bit for
  bit) and K1 over shards ≡ the streamed sweep at 1e-4;
* the port's own: the step leaves its input unchanged, one shard is the
  solo step, every_k over shards ≡ every step, the overflow contract; the
  per-row scan of the packs and the lane compaction ≡ their per-row and
  per-lane counterparts.
"""

import dataclasses
import os
import subprocess
import sys
import textwrap
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import (DistConfig, DistributedSimulation,  # noqa: E402
                              EngineConfig, ForceParams, RebuildPolicy,
                              Simulation, rand)
from repro_torch.core import behaviors as tb  # noqa: E402
from repro_torch.core import distributed as dist  # noqa: E402
from repro_torch.core.diffusion import DiffusionSpec  # noqa: E402
from repro_torch.launch import distributed as launcher  # noqa: E402

SIDE = 48.0
CPU = "cpu"


@pytest.fixture(autouse=True)
def _single_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _canon(pos, *extras):
    o = np.lexsort(pos.T)
    return (pos[o],) + tuple(e[o] for e in extras)


def _live(ch, *names):
    a = np.asarray(ch["alive"])
    return _canon(*(np.asarray(ch[n])[a] for n in ("position",) + names))


def _solo_live(pool, *names):
    ch = {k: v.numpy() for k, v in pool.channels().items()}
    return _live(ch, *names)


def _dist_live(st, *names):
    return _live({k: v.numpy() for k, v in st.channels.items()}, *names)


# ---------------------------------------------------------------------------
# the test scenarios (tests/test_distributed.py's), as the launcher builds
# them (launch/distributed.py: its Drift and RecoveredFate behaviors)
# ---------------------------------------------------------------------------

def sir_behaviors():
    # beta 1.0 makes Infection deterministic; drift, recovery, births and
    # deaths are deterministic by construction
    return launcher.scenario({"scenario": "sir"}).behaviors()


def sir_case(force_impl="streamed"):
    sc = launcher.scenario({"scenario": "sir", "force_impl": force_impl})
    return sc.dcfg, sc.position, sc.init


SIR_STEPS = 20


def forces_case(force_impl="streamed"):
    sc = launcher.scenario({"scenario": "forces", "force_impl": force_impl})
    return sc.dcfg, sc.position, sc.init


def diffusion_case():
    sc = launcher.scenario({"scenario": "diffusion"})
    return sc.dcfg, sc.position, sc.init, sc.behaviors


def _solo(cfg, behaviors, pos, init, steps):
    sim = Simulation(cfg, behaviors, device=CPU)
    st = sim.init_state(pos, **init)
    births = deaths = 0
    for _ in range(steps):
        st = sim.step(st)
        births += int(st.stats.births)
        deaths += int(st.stats.deaths)
    return st, births, deaths


def _dist_run(dcfg, behaviors, pos, init, steps):
    """(final state, summed stats per shard, boundaries per step)."""
    dsim = DistributedSimulation(dcfg, behaviors, device=CPU)
    st = dsim.init_state(pos, **init)
    total = {f: np.zeros(dcfg.n_shards, np.int64) for f in st.stats.FIELDS}
    bounds = [st.boundaries.numpy().copy()]
    for _ in range(steps):
        st = dsim.step(st)
        for f, v in st.stats.items():
            total[f] += v.numpy()
        bounds.append(st.boundaries.numpy().copy())
    return st, total, bounds


# ---------------------------------------------------------------------------
# host helpers ≡ the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 7, -3, 2 ** 31 - 1])
def test_fold_in_equals_jax(seed):
    import jax
    import jax.numpy as jnp
    key = jax.random.PRNGKey(seed)
    data = [0, 1, 3, 2 ** 31, 2 ** 32 - 1]
    want = np.stack([np.asarray(jax.random.fold_in(key, d)) for d in data])
    got = rand.fold_in(rand.prng_key(seed, CPU), torch.tensor(data))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    one = rand.fold_in(rand.prng_key(seed, CPU), 3)
    np.testing.assert_array_equal(one.numpy(), want[2].astype(np.int64))
    vm = jax.vmap(lambda s: jax.random.fold_in(key, s))(
        jnp.arange(4, dtype=jnp.uint32))
    np.testing.assert_array_equal(
        dist.shard_keys(seed, 4, torch.device(CPU)).numpy(),
        np.asarray(vm).astype(np.int64))


def _quantile_inputs(case):
    rng = np.random.default_rng(3)
    if case == "all_dead":
        return np.linspace(0, 10, 64).astype(np.float32), np.zeros(64, bool)
    if case == "single_cluster":
        return np.full(128, 7.25, np.float32), np.ones(128, bool)
    if case == "balanced":
        return (rng.uniform(0, 10, 4096).astype(np.float32),
                rng.uniform(size=4096) < 0.7)
    x = rng.uniform(0, 10, 333).astype(np.float32)     # ties and few agents
    x[::7] = 5.0
    return x, rng.uniform(size=333) < 0.3


@pytest.mark.parametrize("case", ["all_dead", "single_cluster", "balanced",
                                  "ties"])
@pytest.mark.parametrize("n_shards", [1, 4, 8])
def test_quantile_boundaries_equal_the_reference(case, n_shards):
    import jax.numpy as jnp
    from repro.core.distributed import quantile_boundaries as jq
    x, alive = _quantile_inputs(case)
    want = np.asarray(jq(jnp.asarray(x), jnp.asarray(alive), n_shards,
                         0.0, 10.0))
    got = dist.quantile_boundaries(torch.from_numpy(x),
                                   torch.from_numpy(alive), n_shards,
                                   0.0, 10.0)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[0] == 0.0 and got[-1] == 10.0
    assert (got.diff() >= 0).all()


def _pool_channels(n, rng, gaps=True):
    ch = {"position": rng.uniform(0, 10, (n, 3)).astype(np.float32),
          "diameter": rng.uniform(1, 3, n).astype(np.float32),
          "agent_type": rng.integers(0, 3, n).astype(np.int32),
          "alive": (rng.uniform(size=n) < 0.8) if gaps else np.ones(n, bool),
          "extra.owned": np.ones(n, bool),
          "extra.timer": rng.integers(0, 9, n).astype(np.int32)}
    return ch


@pytest.mark.parametrize("local", [200, 70])
def test_partition_global_equals_the_reference(local):
    """Dead gaps in the input, and (at 70) slabs past local_capacity,
    whose extra agents both packages drop."""
    import jax.numpy as jnp
    from repro.core import EngineConfig as JConfig
    from repro.core.distributed import (DistConfig as JDist,
                                        partition_global as jpart,
                                        quantile_boundaries as jq)
    ch = _pool_channels(600, np.random.default_rng(5))
    b = np.asarray(jq(jnp.asarray(ch["position"][:, 0]),
                      jnp.asarray(ch["alive"]), 4, 0.0, 10.0))
    jcfg = JConfig(capacity=600, domain_lo=(0, 0, 0), domain_hi=(10,) * 3,
                   interaction_radius=1.0)
    want = jpart({k: jnp.asarray(v) for k, v in ch.items()}, jnp.asarray(b),
                 JDist(engine=jcfg, n_shards=4, local_capacity=local))
    tcfg = EngineConfig(capacity=600, domain_lo=(0, 0, 0),
                        domain_hi=(10,) * 3, interaction_radius=1.0)
    got = dist.partition_global({k: torch.from_numpy(v)
                                 for k, v in ch.items()},
                                torch.tensor(b),
                                DistConfig(engine=tcfg, n_shards=4,
                                           local_capacity=local))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)


@pytest.mark.parametrize("cap", [1, 16, 64])
def test_pack_channels_equals_the_reference_per_shard(cap):
    """Four shards packed at once ≡ the reference's pack of each shard:
    buffers entry for entry (zeros past the count) and the overflow."""
    import jax.numpy as jnp
    from repro.core.distributed import pack_channels as jpack
    rng = np.random.default_rng(cap)
    shards = [_pool_channels(64, rng) for _ in range(4)]
    masks = [s["alive"] & (s["position"][:, 0] < 3.0) for s in shards]
    masks[2][:] = False                              # an empty band
    stacked = {k: torch.from_numpy(np.stack([s[k] for s in shards]))
               for k in shards[0]}
    got, over = dist.pack_channels(torch.from_numpy(np.stack(masks)),
                                   stacked, cap)
    for i, (s, m) in enumerate(zip(shards, masks)):
        want, w_over = jpack(jnp.asarray(m),
                             {k: jnp.asarray(v) for k, v in s.items()}, cap)
        assert int(over[i]) == int(w_over)
        for k in want:
            np.testing.assert_array_equal(got[k][i].numpy(),
                                          np.asarray(want[k]), err_msg=k)


def test_shard_axis_moves():
    ax = dist.ShardAxis(3)
    x = torch.arange(1, 7, dtype=torch.float32).reshape(3, 2)
    assert ax.shift_forward(x).tolist() == [[0, 0], [1, 2], [3, 4]]
    assert ax.shift_backward(x).tolist() == [[3, 4], [5, 6], [0, 0]]
    assert ax.gather(x[:, :, None]).reshape(-1).tolist() == list(range(1, 7))
    parts = torch.arange(18, dtype=torch.float32).reshape(3, 6)
    assert ax.reduce_scatter(parts).tolist() == [[18, 21], [24, 27],
                                                 [30, 33]]


@pytest.mark.parametrize("shape", [(1, 7), (4, 64), (5, 1)])
def test_row_cumsum_is_each_rows_cumsum(shape):
    """The flat scan less each row's base ≡ ``torch.cumsum`` along the rows
    (an empty row and a full one included)."""
    from repro_torch.core.lanes import row_cumsum
    a = torch.from_numpy(np.random.default_rng(sum(shape)).integers(
        0, 2, shape).astype(np.int32))
    a[0] = 0
    a[-1] = 1
    want = torch.cumsum(a, 1, dtype=torch.int32)
    got = row_cumsum(a)
    assert got.dtype == torch.int32 and torch.equal(got, want)


def test_lane_compaction_permutation_is_each_lanes_solo_one():
    """Over lanes the compaction permutation is each lane's solo
    permutation, moved to the lane's slots."""
    from repro_torch.core.compaction import compaction_permutation
    from repro_torch.core.lanes import Lanes
    alive = torch.from_numpy(np.random.default_rng(3).random(4 * 50) < 0.6)
    alive[:50] = False                              # an empty lane
    perm, n_live = compaction_permutation(alive, Lanes(4, 50))
    for lane in range(4):
        seg = alive[lane * 50:(lane + 1) * 50]
        solo, n = compaction_permutation(seg)
        assert int(n_live[lane]) == int(n)
        assert torch.equal(perm[lane * 50:(lane + 1) * 50], solo + lane * 50)


# ---------------------------------------------------------------------------
# 4 shards ≡ the port's solo Simulation (the reference's bounds)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("force_impl", ["streamed", "k1"])
def test_forces_four_shards_equal_solo(force_impl):
    dcfg, pos, init = forces_case(force_impl)
    st, _, _ = _solo(dcfg.engine, [], pos, init, 5)
    dsim = DistributedSimulation(dcfg, device=CPU)
    dst = dsim.run(dsim.init_state(pos, **init), 5, check_overflow=True)
    (want,), (got,) = _solo_live(st.pool), _dist_live(dst)
    assert want.shape == got.shape
    assert np.abs(want - got).max() < 1e-3
    assert dst.channels["extra.owned"][dst.channels["alive"]].all(), \
        "ghost rows leaked into the committed state"
    counts = dst.stats.n_live.tolist()
    assert max(counts) - min(counts) <= 0.5 * max(counts), counts


def test_k1_over_shards_equals_the_streamed_sweep():
    """K1's plain version over the 4 shard lanes against the streamed sweep
    over the same shards: the SIR case to 1e-4, integers equal."""
    out = {}
    for impl in ("k1", "streamed"):
        dcfg, pos, init = sir_case(impl)
        st, tot, _ = _dist_run(dcfg, sir_behaviors(), pos, init, 6)
        out[impl] = (_dist_live(st, "agent_type", "extra.infect_timer"),
                     tot)
    (pk, tk, ik), sk = out["k1"]
    (ps, ts, is_), ss = out["streamed"]
    assert pk.shape == ps.shape
    assert np.abs(pk - ps).max() <= 1e-4
    np.testing.assert_array_equal(tk, ts)
    np.testing.assert_array_equal(ik, is_)
    for f in ("n_live", "births", "deaths", "halo_overflow",
              "migrate_overflow"):
        np.testing.assert_array_equal(sk[f], ss[f], err_msg=f)


@pytest.fixture(scope="module")
def sir_runs():
    dcfg, pos, init = sir_case()
    solo = _solo(dcfg.engine, sir_behaviors(), pos, init, SIR_STEPS)
    return solo, _dist_run(dcfg, sir_behaviors(), pos, init, SIR_STEPS)


def test_sir_four_shards_equal_solo(sir_runs):
    (st, births, deaths), (dst, tot, bounds) = sir_runs
    for f in ("halo_overflow", "migrate_overflow", "in_flight",
              "thin_slab", "birth_overflow", "box_overflow"):
        assert tot[f].sum() == 0, (f, tot[f])
    assert births > 0 and deaths > 0
    assert tot["births"].sum() == births and tot["deaths"].sum() == deaths
    want = _solo_live(st.pool, "agent_type", "extra.post",
                      "extra.infect_timer")
    got = _dist_live(dst, "agent_type", "extra.post", "extra.infect_timer")
    assert want[0].shape == got[0].shape
    assert np.abs(want[0] - got[0]).max() < 1e-3
    for w, g in zip(want[1:], got[1:]):
        np.testing.assert_array_equal(w, g)
    assert (got[1] != tb.SUSCEPTIBLE).sum() > 10, "the epidemic spread"
    assert not np.array_equal(bounds[0], bounds[-1]), "never rebalanced"
    assert int(dst.stats.n_live.sum()) == int(st.stats.n_live)


def test_diffusion_four_shards_equal_solo():
    dcfg, pos, init, beh = diffusion_case()
    st, _, _ = _solo(dcfg.engine, beh(), pos, init, 8)
    dsim = DistributedSimulation(dcfg, beh(), device=CPU)
    dst = dsim.run(dsim.init_state(pos, **init), 8, check_overflow=True)
    ref = st.conc.numpy()
    assert ref.max() > 0
    assert np.abs(ref - dst.conc.numpy()).max() <= 1e-4 * max(1.0,
                                                                ref.max())
    (want,), (got,) = _solo_live(st.pool), _dist_live(dst)
    assert np.abs(want - got).max() < 1e-3


def test_sharded_ftcs_step_equals_the_full_grid_bit_for_bit():
    from repro_torch.core import diffusion as dm
    from repro_torch.core.lanes import Lanes
    spec = DiffusionSpec(dims=(16, 6, 5), coefficient=0.2, decay=0.01,
                         voxel=1.5)
    conc = torch.from_numpy(np.random.default_rng(2).uniform(
        0, 3, spec.dims).astype(np.float32))
    for n in (1, 2, 4, 8):
        ops = dist._ShardedDiffusionOps(spec, torch.zeros(3),
                                        dist.ShardAxis(n), Lanes(n, 4))
        assert torch.equal(ops.step(conc, 0.3), dm.step(spec, conc, 0.3)), n


def test_sharded_secretion_sums_every_shard_into_its_slab():
    """Each shard's agents secrete into the whole grid (quantile agent
    slabs need not align with the voxel slabs); sampling reads the whole
    grid from every shard."""
    from repro_torch.core import diffusion as dm
    from repro_torch.core.lanes import Lanes
    spec = DiffusionSpec(dims=(8, 4, 4), voxel=2.0)
    origin = torch.zeros(3)
    rng = np.random.default_rng(4)
    pos = torch.from_numpy(rng.uniform(0, 8, (4 * 6, 3)).astype(np.float32))
    amt = torch.from_numpy(rng.uniform(0, 1, 24).astype(np.float32))
    ops = dist._ShardedDiffusionOps(spec, origin, dist.ShardAxis(4),
                                    Lanes(4, 6))
    conc = torch.zeros(spec.dims)
    got = ops.add_sources(conc, pos, amt)
    want = dm.add_sources(spec, conc, pos, amt, origin)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(ops.sample(got, pos).numpy(),
                                  dm.sample(spec, got, pos, origin).numpy())
    np.testing.assert_array_equal(ops.gradient(got, pos).numpy(),
                                  dm.gradient(spec, got, pos,
                                              origin).numpy())


# ---------------------------------------------------------------------------
# 4 shards ≡ the reference's DistributedSimulation (one subprocess)
# ---------------------------------------------------------------------------

_REF_SCRIPT = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import numpy as np
    import jax.numpy as jnp
    from repro.core import (DistConfig, DistributedSimulation, EngineConfig,
                            ForceParams, restore_dist_state, save_dist_state)
    from repro.core.behaviors import (Behavior, BehaviorEffects, Infection,
                                      INFECTED, RECOVERED)

    class Drift(Behavior):
        def __init__(self, vx):
            self.vx = vx

        def __call__(self, ctx, pool, rng):
            step = jnp.asarray([self.vx, 0.0, 0.0]) * ctx.dt
            new_pos = jnp.where(ctx.owned[:, None], pool.position + step,
                                pool.position)
            new_pos = jnp.clip(new_pos, ctx.domain_lo, ctx.domain_hi)
            return BehaviorEffects(set_channels={"position": new_pos})

    class RecoveredFate(Behavior):
        def extra_specs(self):
            return {"post": ((), jnp.int32, 0)}

        def __call__(self, ctx, pool, rng):
            rec = ctx.owned & (pool.agent_type == RECOVERED)
            post = jnp.where(rec, pool.extra["post"] + 1, pool.extra["post"])
            bp = jnp.clip(pool.position + jnp.asarray([0.0, 1.5, 0.0]),
                          ctx.domain_lo, ctx.domain_hi)
            return BehaviorEffects(
                set_channels={"extra.post": post},
                birth_channels={"position": bp, "diameter": pool.diameter,
                                "agent_type": jnp.zeros_like(
                                    pool.agent_type)},
                birth_valid=rec & (post == 3),
                death_mask=rec & (post >= 6))

    inp = np.load(sys.argv[1])
    SIDE, steps = float(inp["side"]), int(inp["steps"])
    cfg = EngineConfig(capacity=1024, domain_lo=(0, 0, 0),
                       domain_hi=(SIDE,) * 3, interaction_radius=4.0,
                       dt=0.5, max_per_box=64, query_chunk=128,
                       force=ForceParams(max_displacement=0.5))
    dcfg = DistConfig(engine=cfg, n_shards=4, local_capacity=512,
                      halo_capacity=256, migrate_capacity=128,
                      rebalance_frequency=3)
    beh = [Drift(1.2), Infection(radius=4.0, beta=1.0, recovery_time=4),
           RecoveredFate()]
    dsim = DistributedSimulation(dcfg, beh)
    st = dsim.init_state(inp["pos"], diameter=inp["dia"],
                         agent_type=inp["types"],
                         extra_init={"infect_timer": inp["timer"]})
    out = {"rng0": np.asarray(st.rng), "bounds0": np.asarray(st.boundaries)}
    stats, bounds = [], []
    for _ in range(steps):
        st = dsim.step(st)
        stats.append(np.stack([np.asarray(st.stats[f]).ravel()
                               for f in st.stats.FIELDS]))
        bounds.append(np.asarray(st.boundaries))
    out["stats"] = np.stack(stats)
    out["bounds"] = np.stack(bounds)
    out["rng"] = np.asarray(st.rng)
    for k, v in st.channels.items():
        out["ch." + k] = np.asarray(v)

    def one_step(st, tag):
        st = dsim.step(st)
        out[tag + ".stats"] = np.stack([np.asarray(st.stats[f]).ravel()
                                        for f in st.stats.FIELDS])
        for k, v in st.channels.items():
            out[tag + ".ch." + k] = np.asarray(v)

    # checkpoints across the packages: this run's, and the port's
    save_dist_state(sys.argv[3], st, dcfg)
    one_step(st, "next")
    pst, _ = restore_dist_state(sys.argv[4], dcfg, beh)
    one_step(pst, "port_next")
    np.savez(sys.argv[2], fields=np.array(st.stats.FIELDS), **out)
    print("RESULT ok")
""")


@pytest.fixture(scope="module")
def reference_sir(tmp_path_factory):
    pytest.importorskip("jax")
    d = tmp_path_factory.mktemp("ref_sir")
    dcfg, pos, init = sir_case()
    np.savez(d / "in.npz", pos=pos, dia=init["diameter"],
             types=init["agent_type"],
             timer=init["extra_init"]["infect_timer"], side=SIDE,
             steps=SIR_STEPS)
    # a port checkpoint after 3 steps, for the reference to restore
    dsim = DistributedSimulation(dcfg, sir_behaviors(), device=CPU)
    st = dsim.run(dsim.init_state(pos, **init), 3)
    from repro_torch.core import save_dist_state
    save_dist_state(str(d / "port_ck"), st, dcfg)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(os.path.dirname(__file__), "..", "src")
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run([sys.executable, "-c", _REF_SCRIPT,
                           str(d / "in.npz"), str(d / "out.npz"),
                           str(d / "ref_ck"), str(d / "port_ck")], env=env,
                          capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = dict(np.load(d / "out.npz"))
    out["ref_ck"], out["port_state"] = str(d / "ref_ck"), st
    return out


def test_sir_four_shards_equal_the_reference(reference_sir):
    ref = reference_sir
    dcfg, pos, init = sir_case()
    dsim = DistributedSimulation(dcfg, sir_behaviors(), device=CPU)
    st = dsim.init_state(pos, **init)
    np.testing.assert_array_equal(st.rng.numpy(),
                                  ref["rng0"].astype(np.int64))
    np.testing.assert_array_equal(st.boundaries.numpy(), ref["bounds0"])
    fields = [str(f) for f in ref["fields"]]
    for i in range(SIR_STEPS):
        st = dsim.step(st)
        got = np.stack([st.stats[f].numpy() for f in fields])
        np.testing.assert_array_equal(got, ref["stats"][i],
                                      err_msg=f"stats after step {i}")
        np.testing.assert_allclose(st.boundaries.numpy(), ref["bounds"][i],
                                   rtol=0, atol=1e-4)
    np.testing.assert_array_equal(st.rng.numpy(),
                                  ref["rng"].astype(np.int64))
    c = dcfg.local_capacity
    names = ("agent_type", "extra.post", "extra.infect_timer", "born_iter",
             "extra.owned")
    for s in range(dcfg.n_shards):
        sl = slice(s * c, (s + 1) * c)
        want = _live({k[3:]: v[sl] for k, v in ref.items()
                      if k.startswith("ch.")}, *names)
        got = _live({k: v.numpy()[sl] for k, v in st.channels.items()},
                    *names)
        assert want[0].shape == got[0].shape, s
        assert np.abs(want[0] - got[0]).max() < 1e-3, s
        for w, g, n in zip(want[1:], got[1:], names):
            np.testing.assert_array_equal(g, w, err_msg=f"shard {s} {n}")


@pytest.fixture(scope="module")
def sir_on_ranks(tmp_path_factory, reference_sir):
    """The SIR case on 4 gloo ranks, one shard each, through the launcher
    (``launch/distributed.py``, one subprocess): 20 steps from the inputs,
    and one step from the reference's checkpoint."""
    import rank_cases
    d = tmp_path_factory.mktemp("sir_ranks")
    rank_cases.launch([
        {"name": "sir", "scenario": "sir", "steps": SIR_STEPS},
        {"name": "ref_next", "scenario": "sir", "steps": 1,
         "resume": reference_sir["ref_ck"]}], 4, d)
    return {name: dict(np.load(d / f"{name}.npz"))
            for name in ("sir", "ref_next")}


def _stats_by_field(run, fields, i):
    """Step ``i``'s stats of a launcher run, (len(fields), n_shards)."""
    own = [str(f) for f in run["fields"]]
    return np.stack([run["stats"][i][own.index(f)] for f in fields])


def test_sir_four_ranks_equal_the_reference(reference_sir, sir_on_ranks):
    """test_sir_four_shards_equal_the_reference's assertions, on 4 gloo
    ranks of one shard each."""
    ref = reference_sir
    run = sir_on_ranks["sir"]
    dcfg, pos, init = sir_case()
    np.testing.assert_array_equal(run["rng0"],
                                  ref["rng0"].astype(np.int64))
    np.testing.assert_array_equal(run["bounds"][0], ref["bounds0"])
    fields = [str(f) for f in ref["fields"]]
    for i in range(SIR_STEPS):
        got = _stats_by_field(run, fields, i)
        np.testing.assert_array_equal(got, ref["stats"][i],
                                      err_msg=f"stats after step {i}")
        np.testing.assert_allclose(run["bounds"][i + 1], ref["bounds"][i],
                                   rtol=0, atol=1e-4)
    np.testing.assert_array_equal(run["rng"],
                                  ref["rng"].astype(np.int64))
    c = dcfg.local_capacity
    names = ("agent_type", "extra.post", "extra.infect_timer", "born_iter",
             "extra.owned")
    for s in range(dcfg.n_shards):
        sl = slice(s * c, (s + 1) * c)
        want = _live({k[3:]: v[sl] for k, v in ref.items()
                      if k.startswith("ch.")}, *names)
        got = _live({k[3:]: v[sl] for k, v in run.items()
                     if k.startswith("ch.")}, *names)
        assert want[0].shape == got[0].shape, s
        assert np.abs(want[0] - got[0]).max() < 1e-3, s
        for w, g, n in zip(want[1:], got[1:], names):
            np.testing.assert_array_equal(g, w, err_msg=f"shard {s} {n}")


def test_a_reference_checkpoint_steps_on_four_ranks(reference_sir,
                                                    sir_on_ranks):
    """The reference's 4-shard checkpoint (after 20 steps) restored onto 4
    gloo ranks, each keeping its shard: their next step is the
    reference's."""
    ref = reference_sir
    run = sir_on_ranks["ref_next"]
    fields = [str(f) for f in ref["fields"]]
    np.testing.assert_array_equal(_stats_by_field(run, fields, 0),
                                  ref["next.stats"])
    st = types.SimpleNamespace(
        stats=types.SimpleNamespace(n_live=run["stats"][0][0]),
        channels={k[3:]: torch.from_numpy(v) for k, v in run.items()
                  if k.startswith("ch.")})
    _same_shards(ref, "next.ch.", st, sir_case()[0].local_capacity,
                 ("agent_type", "extra.post", "extra.infect_timer"))


def _same_shards(ref, prefix, st, c, names):
    """Each shard's live agents equal as sets: integers exact, positions
    within 1e-4."""
    for s in range(st.stats.n_live.shape[0]):
        sl = slice(s * c, (s + 1) * c)
        want = _live({k[len(prefix):]: v[sl] for k, v in ref.items()
                      if k.startswith(prefix)}, *names)
        got = _live({k: v.numpy()[sl] for k, v in st.channels.items()},
                    *names)
        assert want[0].shape == got[0].shape, s
        assert np.abs(want[0] - got[0]).max(initial=0.0) <= 1e-4, s
        for w, g, n in zip(want[1:], got[1:], names):
            np.testing.assert_array_equal(g, w, err_msg=f"shard {s} {n}")


def test_a_reference_checkpoint_steps_in_the_port(reference_sir):
    """The reference's 4-shard checkpoint (after 20 steps) restores into
    the port, whose next step is the reference's next step."""
    from repro_torch.core import restore_dist_state
    ref = reference_sir
    dcfg, _, _ = sir_case()
    st, rcfg = restore_dist_state(ref["ref_ck"], dcfg, sir_behaviors(),
                                  device=CPU)
    assert rcfg.n_shards == 4
    assert int(st.iteration) == SIR_STEPS
    st = DistributedSimulation(rcfg, sir_behaviors(), device=CPU).step(st)
    fields = [str(f) for f in ref["fields"]]
    np.testing.assert_array_equal(
        np.stack([st.stats[f].numpy() for f in fields]), ref["next.stats"])
    _same_shards(ref, "next.ch.", st, dcfg.local_capacity,
                 ("agent_type", "extra.post", "extra.infect_timer"))


def test_a_port_checkpoint_steps_in_the_reference(reference_sir):
    """The port's 4-shard checkpoint (after 3 steps) restores into the
    reference, whose next step is the port's next step."""
    ref = reference_sir
    dcfg, _, _ = sir_case()
    st = DistributedSimulation(dcfg, sir_behaviors(), device=CPU).step(
        ref["port_state"])
    fields = [str(f) for f in ref["fields"]]
    np.testing.assert_array_equal(
        np.stack([st.stats[f].numpy() for f in fields]),
        ref["port_next.stats"])
    _same_shards(ref, "port_next.ch.", st, dcfg.local_capacity,
                 ("agent_type", "extra.post", "extra.infect_timer"))


# ---------------------------------------------------------------------------
# tests/test_fused.py's 4-shard contract
# ---------------------------------------------------------------------------

def test_fused_equals_sequential_on_four_shards():
    """Same slabs, same per-shard order: the fused and the sequential
    sweeps give the same trajectory bit for bit."""
    side, n = 64.0, 1024
    rng = np.random.default_rng(7)
    pos = rng.uniform(2, side - 2, (n, 3)).astype(np.float32)
    types = np.zeros(n, np.int32)
    types[:32] = tb.INFECTED
    out = {}
    for fused in (True, False):
        cfg = EngineConfig(capacity=n, domain_lo=(0., 0., 0.),
                           domain_hi=(side,) * 3, interaction_radius=3.0,
                           use_forces=True, max_per_box=32,
                           fused_sweep=fused)
        dcfg = DistConfig(engine=cfg, n_shards=4, local_capacity=2 * n // 4,
                          halo_capacity=256, migrate_capacity=256)
        sim = DistributedSimulation(
            dcfg, [tb.Infection(radius=3.0, beta=0.4, recovery_time=8)],
            device=CPU)
        st = sim.init_state(pos, np.full(n, 2.5, np.float32), types,
                            extra_init={"infect_timer":
                                        np.full(n, 8, np.int32)})
        for _ in range(8):
            st = sim.step(st)
        out[fused] = _live(sim.gather_channels(st), "agent_type")
    assert out[True][0].shape == out[False][0].shape
    np.testing.assert_array_equal(out[True][0], out[False][0])
    np.testing.assert_array_equal(out[True][1], out[False][1])


# ---------------------------------------------------------------------------
# the port's own contracts
# ---------------------------------------------------------------------------

def test_step_leaves_its_input_unchanged():
    dcfg, pos, init = sir_case("k1")
    dsim = DistributedSimulation(dcfg, sir_behaviors(), device=CPU)
    st = dsim.run(dsim.init_state(pos, **init), 2)
    before = {k: v.clone() for k, v in st.channels.items()}
    b, r, c = st.boundaries.clone(), st.rng.clone(), st.conc.clone()
    dsim.step(st)
    for k, v in before.items():
        assert torch.equal(st.channels[k], v), k
    assert torch.equal(st.boundaries, b) and torch.equal(st.rng, r)
    assert torch.equal(st.conc, c)
    assert int(st.iteration) == 2 and st.iteration.device.type == "cpu"


def test_one_shard_is_the_solo_step():
    """n_shards 1: no ghosts, no migration; the trajectory is the solo
    Simulation's bit for bit."""
    dcfg, pos, init = sir_case("k1")
    dcfg = dataclasses.replace(dcfg, n_shards=1, local_capacity=1024,
                               halo_capacity=16, migrate_capacity=16)
    st, _, _ = _solo(dcfg.engine, sir_behaviors(), pos, init, 6)
    dst, _, _ = _dist_run(dcfg, sir_behaviors(), pos, init, 6)
    want = _solo_live(st.pool, "agent_type", "extra.post")
    got = _dist_live(dst, "agent_type", "extra.post")
    for w, g in zip(want, got):
        np.testing.assert_array_equal(w, g)


def test_every_k_over_shards_equals_every_step():
    """Per-shard caches under every_k: a shard whose bands stay empty
    skips its builds while its neighbors, with live ghosts and migrants,
    rebuild every step (mixed flags in one step, read in one transfer).
    Forces only, so stale-superset candidates add exact zeros; the wider
    boxes reorder each row's sum, so positions agree to 1e-4."""
    rng = np.random.default_rng(3)
    sheets = []
    for lo in (5.0, 11.0, 29.0, 41.0):       # 11-13 straddles x = 12
        p = rng.uniform(2, SIDE - 2, (50, 3)).astype(np.float32)
        p[:, 0] = rng.uniform(lo, lo + 2, 50)
        sheets.append(p)
    pos = np.concatenate(sheets)
    bounds = torch.tensor([0.0, 12.0, 24.0, 36.0, 48.0])
    out = {}
    for mode in ("every_step", "every_k"):
        eng = EngineConfig(
            capacity=256, domain_lo=(0, 0, 0), domain_hi=(SIDE,) * 3,
            interaction_radius=4.0, dt=0.1, max_per_box=64,
            force=ForceParams(max_displacement=0.5), force_impl="k1",
            rebuild=(RebuildPolicy("every_k", k=4, displacement_bound=0.75)
                     if mode == "every_k" else RebuildPolicy()))
        dcfg = DistConfig(engine=eng, n_shards=4, local_capacity=128,
                          halo_capacity=64, migrate_capacity=32)
        dsim = DistributedSimulation(dcfg, device=CPU)
        st = dsim.init_state(pos, diameter=np.full(200, 1.5, np.float32))
        # slab edges between the sheets, the agents re-partitioned on them
        st = dataclasses.replace(
            st, boundaries=bounds,
            channels=dist.partition_global(st.channels, bounds, dcfg))
        skips = np.zeros(4, np.int64)
        for _ in range(6):
            st = dsim.step(st)
            skips += st.stats.rebuild_skips.numpy()
            assert not st.stats.flags(), st.stats.flags()
        out[mode] = (_dist_live(st)[0], skips)
    assert out["every_k"][0].shape == out["every_step"][0].shape
    assert np.abs(out["every_k"][0] - out["every_step"][0]).max() < 1e-4
    k_skips = out["every_k"][1]
    assert (k_skips[:2] == 0).all() and (k_skips[2:] > 0).all(), k_skips
    assert (out["every_step"][1] == 0).all()


def test_overflow_flags_raise_in_severity_order():
    dcfg, pos, init = forces_case("k1")
    tight = dataclasses.replace(dcfg, halo_capacity=4, migrate_capacity=1)
    dsim = DistributedSimulation(tight, device=CPU)
    with pytest.raises(RuntimeError, match="iteration 0: halo overflow"):
        dsim.run(dsim.init_state(pos, **init), 2, check_overflow=True)
    with pytest.raises(dist.SlabCapacityError, match="local_capacity=64"):
        DistributedSimulation(dataclasses.replace(
            dcfg, local_capacity=64, halo_capacity=32, migrate_capacity=16),
            device=CPU).init_state(pos, **init)


def test_config_checks_are_the_reference_s():
    dcfg, _, _, _ = diffusion_case()
    with pytest.raises(ValueError, match="divisible by n_shards=3"):
        DistributedSimulation(dataclasses.replace(dcfg, n_shards=3),
                              device=CPU)
    with pytest.raises(ValueError, match="halo/migrate capacity"):
        DistributedSimulation(dataclasses.replace(dcfg, halo_capacity=0),
                              device=CPU)
    assert dcfg.total_capacity == 128 + 2 * 64
    assert dcfg.halo_width == 4.0


def test_distributed_simulation_defaults_to_cuda_and_raises_without_it():
    dcfg, _, _ = forces_case()
    if torch.cuda.is_available():
        assert DistributedSimulation(dcfg).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DistributedSimulation(dcfg)


def test_ghost_rows_never_count_or_commit():
    """Directly on the core: with an owned channel, ghosts are gather
    sources only (not queried, not killed, not counted) and newborns are
    committed owned."""
    from repro_torch.core import make_iteration_core, stage_pool
    cfg = EngineConfig(capacity=64, domain_lo=(0, 0, 0), domain_hi=(16,) * 3,
                       interaction_radius=3.0, force_impl="streamed",
                       max_per_box=32)
    beh = [tb.GrowDivide(rate=5.0, threshold_diameter=3.0),
           tb.RandomDeath(rate=0.5)]
    rng = np.random.default_rng(1)
    pos = rng.uniform(4, 12, (40, 3)).astype(np.float32)
    pool = stage_pool(64, beh, pos, diameter=np.full(40, 2.0, np.float32),
                      extra_specs={"owned": ((), torch.bool, True)},
                      device=CPU)
    pool.extra["owned"][20:40] = False                 # 20 ghosts
    core = make_iteration_core(cfg, beh, torch.device(CPU),
                               owned_channel="owned")
    out, _, _, stats, _ = core(pool, torch.zeros(1, 1, 1),
                               rand.prng_key(0, CPU),
                               torch.zeros((), dtype=torch.int32))
    owned = out.extra["owned"] & out.alive
    ghosts = ~out.extra["owned"] & out.alive
    assert int(ghosts.sum()) == 20, "a ghost died or was dropped"
    assert int(stats.n_live) == int(owned.sum())
    assert int(stats.deaths) > 0 and int(stats.births) > 0
    # ghosts were never queried: their positions and diameters are as staged
    g_pos = out.position[ghosts].numpy()
    np.testing.assert_array_equal(np.sort(g_pos, 0),
                                  np.sort(pos[20:40], 0))
