"""Run the distributed engine with one block of shards a rank of a
``torch.distributed`` group: one rank a card over NCCL, or gloo ranks on
the CPU.

    # 4 gloo ranks on the CPU (one shard a rank), the SIR scenario:
    PYTHONPATH=src python -m repro_torch.launch.distributed --ranks 4 \\
        --device cpu --scenario sir --steps 20 --out /tmp/sir
    # one rank a card over NCCL (the default device):
    PYTHONPATH=src python -m repro_torch.launch.distributed --ranks 4 \\
        --scenario weak --agents-per-shard 131072 --shards 4 --steps 10 \\
        --out chiprun_out/weak
    # under torchrun, which sets RANK, WORLD_SIZE and LOCAL_RANK:
    PYTHONPATH=src torchrun --standalone --nproc-per-node 4 -m \\
        repro_torch.launch.distributed --scenario weak --steps 10 \\
        --out chiprun_out/weak

Rank r of W steps shards ``[r·S/W, (r+1)·S/W)`` of the scenario's S
(``core/transport.py``); W = 1 runs them all as lanes of one device
through the group. ``--ranks`` spawns the W processes
(``torch.multiprocessing``, a ``FileStore`` rendezvous in a temporary
directory: no network). Every group has a timeout (``--timeout``), so a
rank that misses a collective fails instead of hanging; every spawned
rank runs torch on one CPU thread. With NCCL, bootstrap goes over the
loopback (``NCCL_SOCKET_IFNAME=lo`` unless set) and ``NCCL_DEBUG=WARN``
prints what NCCL finds wrong.

Each job writes, from rank 0, ``OUT/<name>.npz`` (the whole run's final
channels, grid and keys as one device would hold them, every step's
stats of every shard and the slab boundaries) and ``OUT/<name>.json``
(host-clock ms per step, and per rank its kernel launches, peak memory
and, with ``profile``, the profiled steps' device time, idle share and
device ms in NCCL kernels: readings of those steps, which the profiler
slows, and in which a rank waiting for another spins in NCCL kernels, so
the least NCCL time over the ranks is the transfers'). ``--plan FILE``
runs a JSON list of jobs in one launch; a job is a dict with
``scenario`` and ``steps`` and optionally ``name``, scenario options
(``force_impl``, ``agents_per_shard``, ``n_shards``, ``skin``) and
``profile`` (steps to profile on the card).

:func:`run_job` with no group runs the same job as lanes of one device:
what the tests and ``chip_smoke.py`` hold the ranks against.
:func:`spawn_ranks` runs any rank function over a group, and
:func:`run_steps` times and records the steps of an engine built by the
caller (a ladder, a restored checkpoint).
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import json
import os
import statistics
import tempfile
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..core import (DiffusionSpec, DistConfig, DistributedCapacityLadder,
                    DistributedSimulation, DtypePolicy, EngineConfig,
                    ForceParams, PairListConfig, RebuildPolicy, StepStats)
from ..core import behaviors as tb
from ..core.distributed import gather_state, rank_device
from ..device import DeviceLike
from ..kernels import launch_counters

TIMEOUT_S = 120


# ---------------------------------------------------------------------------
# Scenarios: (DistConfig, behaviors factory, positions, init) from a seed
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Scenario:
    dcfg: DistConfig
    behaviors: Callable[[], list]
    position: np.ndarray
    init: Dict


class Drift(tb.Behavior):
    """Deterministic +x drift: every agent crosses slab boundaries."""
    name = "drift"

    def __init__(self, vx: float):
        self.vx = vx

    def __call__(self, ctx, pool, rng):
        step = torch.tensor([self.vx, 0.0, 0.0], device=pool.device) * ctx.dt
        new_pos = torch.where(ctx.owned[:, None], pool.position + step,
                              pool.position)
        new_pos = torch.clamp(new_pos, ctx.domain_lo, ctx.domain_hi)
        return tb.BehaviorEffects(set_channels={"position": new_pos})


class RecoveredFate(tb.Behavior):
    """Deterministic births and deaths: a recovered agent seeds one
    susceptible child 3 steps after recovery and dies after 6."""
    name = "fate"

    def extra_specs(self):
        return {"post": ((), torch.int32, 0)}

    def __call__(self, ctx, pool, rng):
        rec = ctx.owned & (pool.agent_type == tb.RECOVERED)
        post = torch.where(rec, pool.extra["post"] + 1, pool.extra["post"])
        bp = torch.clamp(pool.position + torch.tensor(
            [0.0, 1.5, 0.0], device=pool.device), ctx.domain_lo,
            ctx.domain_hi)
        return tb.BehaviorEffects(
            set_channels={"extra.post": post},
            birth_channels={"position": bp, "diameter": pool.diameter,
                            "agent_type": torch.zeros_like(pool.agent_type)},
            birth_valid=rec & (post == 3), death_mask=rec & (post >= 6))


SIDE = 48.0


def _forces(force_impl: str = "streamed") -> Scenario:
    """tests/test_distributed.py's forces case: 400 agents, 4 shards."""
    rng = np.random.default_rng(0)
    cfg = EngineConfig(capacity=512, domain_lo=(0, 0, 0),
                       domain_hi=(SIDE,) * 3, interaction_radius=4.0,
                       dt=0.1, max_per_box=64, query_chunk=128,
                       force=ForceParams(max_displacement=0.5),
                       force_impl=force_impl)
    pos = rng.uniform(2, SIDE - 2, (400, 3)).astype(np.float32)
    return Scenario(DistConfig(engine=cfg, n_shards=4, local_capacity=256,
                               halo_capacity=128, migrate_capacity=64),
                    list, pos, dict(diameter=np.full(400, 3.0, np.float32)))


def _sir(force_impl: str = "streamed", narrowed: bool = False) -> Scenario:
    """tests/test_distributed.py's SIR case: drift, deterministic
    infection, births and deaths, migration, a rebalance every 3 steps
    (``narrowed``: bf16 diameters, int16 types and neighbor counts)."""
    rng = np.random.default_rng(0)
    rng.uniform(2, SIDE - 2, (400, 3))     # the forces case's draw
    n = 500
    cfg = EngineConfig(capacity=1024, domain_lo=(0, 0, 0),
                       domain_hi=(SIDE,) * 3, interaction_radius=4.0,
                       dt=0.5, max_per_box=64, query_chunk=128,
                       force=ForceParams(max_displacement=0.5),
                       force_impl=force_impl)
    if narrowed:
        cfg = dataclasses.replace(cfg, dtypes=DtypePolicy(
            aux_float="bfloat16", compact_ints=True))
    pos = rng.uniform(1, SIDE - 1, (n, 3)).astype(np.float32)
    types = np.zeros(n, np.int32)
    types[:10] = tb.INFECTED
    init = dict(diameter=np.full(n, 2.0, np.float32), agent_type=types,
                extra_init={"infect_timer": np.full(n, 4, np.int32)})
    dcfg = DistConfig(engine=cfg, n_shards=4, local_capacity=512,
                      halo_capacity=256, migrate_capacity=128,
                      rebalance_frequency=3)
    return Scenario(dcfg, lambda: [
        Drift(1.2), tb.Infection(radius=4.0, beta=1.0, recovery_time=4),
        RecoveredFate()], pos, init)


def _diffusion() -> Scenario:
    """tests/test_distributed.py's sharded diffusion with secretion and
    chemotaxis."""
    rng = np.random.default_rng(0)
    dspec = DiffusionSpec(dims=(16, 8, 8), coefficient=0.2, decay=0.01,
                          voxel=3.0)
    cfg = EngineConfig(capacity=256, domain_lo=(0, 0, 0),
                       domain_hi=(SIDE, 24, 24), interaction_radius=4.0,
                       dt=0.5, use_forces=False, max_per_box=64,
                       query_chunk=64, diffusion=dspec, diffusion_substeps=2)
    pos = rng.uniform(1, 23, (200, 3)).astype(np.float32)
    pos[:, 0] = rng.uniform(1, SIDE - 1, 200)
    return Scenario(DistConfig(engine=cfg, n_shards=4, local_capacity=128,
                               halo_capacity=64, migrate_capacity=32),
                    lambda: [tb.Secretion(rate=2.0), tb.Chemotaxis(speed=0.8)],
                    pos, dict(diameter=np.full(200, 2.0, np.float32)))


def _every_k(skin: float = 1.0, force_impl: str = "k1") -> Scenario:
    """Forces from a pair list under every_k over four sheets of agents,
    one a slab: shards 0-2 receive ghosts from their right neighbors and
    rebuild every step, the last receives none and reuses its cache, so
    the shards' rebuild flags differ within a step."""
    rng = np.random.default_rng(3)
    sheets = []
    for lo in (5.0, 17.0, 29.0, 41.0):
        p = rng.uniform(2, SIDE - 2, (60, 3)).astype(np.float32)
        p[:, 0] = rng.uniform(lo, lo + 2, 60)
        sheets.append(p)
    cfg = EngineConfig(
        capacity=256, domain_lo=(0, 0, 0), domain_hi=(SIDE,) * 3,
        interaction_radius=4.0, dt=0.1, max_per_box=64,
        force=ForceParams(max_displacement=0.5), force_impl=force_impl,
        rebuild=RebuildPolicy("every_k", k=4, displacement_bound=0.75),
        pairlist=PairListConfig(skin=skin, max_pairs=64))
    return Scenario(DistConfig(engine=cfg, n_shards=4, local_capacity=128,
                               halo_capacity=64, migrate_capacity=32),
                    list, np.concatenate(sheets),
                    dict(diameter=np.full(240, 1.5, np.float32)))


def _ladder() -> Scenario:
    """tests/test_ladder.py's distributed ladder: growth and drift from
    slabs of 48 slots, so local, halo and migration capacities grow."""
    rng = np.random.default_rng(1)
    side, n0 = 64.0, 64
    cfg = EngineConfig(capacity=n0, domain_lo=(0, 0, 0),
                       domain_hi=(side,) * 3, interaction_radius=4.0, dt=1.0,
                       max_per_box=8, query_chunk=128,
                       force=ForceParams(max_displacement=0.5))
    pos = rng.uniform(2, side - 2, (n0, 3)).astype(np.float32)
    return Scenario(
        DistConfig(engine=cfg, n_shards=4, local_capacity=48,
                   halo_capacity=24, migrate_capacity=12,
                   rebalance_frequency=3),
        lambda: [tb.GrowDivide(rate=0.8, threshold_diameter=6.0),
                 Drift(1.0)],
        pos, dict(diameter=np.full(n0, 5.2, np.float32)))


def _weak(agents_per_shard: int = 131_072, n_shards: int = 4,
          force_impl: str = "k1") -> Scenario:
    """benchmarks/distributed.py:64-89 (its weak-scaling case) at
    ``n_shards`` shards of ``agents_per_shard`` agents."""
    n_total = agents_per_shard * n_shards
    rng = np.random.default_rng(n_shards)
    side = float(np.ceil((n_total / 2.0) ** (1 / 3)) * 4.0)
    cfg = EngineConfig(capacity=n_total, domain_lo=(0, 0, 0),
                       domain_hi=(side,) * 3, interaction_radius=4.0,
                       dt=0.05, max_per_box=32, query_chunk=4096,
                       force=ForceParams(max_displacement=0.5),
                       force_impl=force_impl)
    per = n_total // n_shards
    band = int(n_total * cfg.interaction_radius / side * 2.5) + 256
    dcfg = DistConfig(engine=cfg, n_shards=n_shards,
                      local_capacity=int(per * 1.25) + 64,
                      halo_capacity=min(band, int(per * 1.25) + 64),
                      migrate_capacity=max(256, per // 16),
                      rebalance_frequency=4)
    pos = rng.uniform(1.0, side - 1.0, (n_total, 3)).astype(np.float32)
    return Scenario(dcfg, list, pos,
                    dict(diameter=np.full(n_total, 3.0, np.float32)))


SCENARIOS: Dict[str, Callable[..., Scenario]] = {
    "forces": _forces, "sir": _sir,
    "narrowed": lambda **kw: _sir(narrowed=True, **kw),
    "diffusion": _diffusion, "every_k": _every_k, "ladder": _ladder,
    "weak": _weak}
_SCENARIO_OPTIONS = ("force_impl", "agents_per_shard", "n_shards", "skin")


def scenario(job: Dict) -> Scenario:
    """The job's scenario, built from its options."""
    return SCENARIOS[job["scenario"]](**{k: job[k] for k in _SCENARIO_OPTIONS
                                         if k in job})


# ---------------------------------------------------------------------------
# One job, on every rank of a group (or as lanes of one device)
# ---------------------------------------------------------------------------

def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _nccl_ms(trace: str, steps: int) -> float:
    """Device ms a step in NCCL kernels, from a Chrome trace."""
    events = json.loads(Path(trace).read_text())["traceEvents"]
    us = sum(e["dur"] for e in events if e.get("cat") == "kernel"
             and "nccl" in e.get("name", "").lower())
    return us / 1e3 / steps


def run_job(job: Dict, group=None, device: DeviceLike = None) -> Dict:
    """Run one job: the scenario's init, then :func:`run_steps`. Every
    rank of ``group`` calls it alike; with no group the shards are lanes
    of ``device``. ``device=None`` means the CUDA card (with a group, the
    rank's) and raises without one; ``device="cpu"`` runs on the CPU."""
    device = rank_device(device, group)
    sc = scenario(job)
    sim = DistributedSimulation(sc.dcfg, sc.behaviors(), device=device,
                                group=group)
    return run_steps(sim, sim.init_state(sc.position, **sc.init),
                     job["steps"], job.get("profile", 0))


def run_steps(sim, st, steps: int, profile: int = 0) -> Dict:
    """``steps`` steps of ``sim`` (a ``DistributedSimulation``, or a
    ``DistributedCapacityLadder``: its rung of the moment) from ``st``,
    each timed on the host clock to a synchronise, every shard's stats
    read after each; then, with ``profile`` on a card, that many profiled
    steps. Kernel launches are counted and the card's peak memory read
    from the first step on. Returns the final ``state``, the whole run's
    ``arrays`` on rank 0 (None on the other ranks) and this rank's own
    numbers ``own``."""
    def engine():
        return (sim.sim if isinstance(sim, DistributedCapacityLadder)
                else sim)
    device = engine().device
    counters = launch_counters()
    for fn in counters.values():
        fn.launches = 0
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    bounds = [st.boundaries.cpu().numpy()]
    rng0 = engine().shards.gather(st.rng[:, None], 0)
    stats, ms = [], []
    for _ in range(steps):
        _sync(device)
        t0 = time.perf_counter()
        st = sim.step(st)
        _sync(device)
        ms.append((time.perf_counter() - t0) * 1e3)
        g = engine().global_stats(st.stats)
        stats.append(torch.stack([v for _, v in g.items()]).cpu().numpy())
        bounds.append(st.boundaries.cpu().numpy())
    launches = {k: fn.launches for k, fn in counters.items()}
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else None)
    final = engine()
    prof = None
    if profile:
        from .profile_step import profile_steps
        with tempfile.TemporaryDirectory() as tmp:
            trace = os.path.join(tmp, "trace.json")
            st, prof = profile_steps(final, st, profile, trace)
            prof["nccl_ms_per_step"] = _nccl_ms(trace, profile)
        prof = {k: prof[k] for k in (
            "ms_per_step_profiled", "device_busy_ms", "device_idle_share",
            "launches", "nccl_ms_per_step", "top_device_ops")}
    whole = gather_state(st, final.dcfg, final.shards, dst=0)
    arrays = None
    if whole is not None:
        arrays = {"ch." + k: (v.float() if v.dtype == torch.bfloat16 else v
                              ).cpu().numpy()
                  for k, v in whole.channels.items()}
        arrays.update(conc=whole.conc.cpu().numpy(),
                      rng=whole.rng.cpu().numpy(),
                      rng0=rng0.cpu().numpy(), bounds=np.stack(bounds),
                      stats=np.array(stats, np.int32).reshape(
                          len(stats), len(StepStats.FIELDS),
                          final.dcfg.n_shards),
                      fields=np.array(StepStats.FIELDS))
    own = {"launches": launches, "peak_bytes": peak, "ms": ms,
           "profile": prof}
    return {"state": st, "arrays": arrays, "own": own}


def write_job(out_dir: str, job: Dict, world: int, device: torch.device,
              result: Dict, per_rank: List[Dict]) -> None:
    """``OUT/<name>.npz`` and ``OUT/<name>.json`` of one job."""
    name = job.get("name", job["scenario"])
    os.makedirs(out_dir, exist_ok=True)
    np.savez(os.path.join(out_dir, name + ".npz"), **result["arrays"])
    ms = result["own"]["ms"]
    meta = {"job": job, "world": world, "device": str(device),
            "ms_per_step": ms,
            "ms_per_step_median": statistics.median(ms) if ms else None,
            "ranks": per_rank}
    if device.type == "cuda":
        meta["card"] = torch.cuda.get_device_name(device)
    Path(out_dir, name + ".json").write_text(json.dumps(meta, indent=1))


def run_jobs(group, device, jobs: Sequence[Dict], out_dir: str,
             run: Callable = run_job) -> None:
    """Every job in turn on this rank, each through ``run`` (called as
    :func:`run_job`); rank 0 writes each job's files, with every rank's
    own numbers."""
    device = torch.device(device)
    rank, world = dist.get_rank(group), dist.get_world_size(group)
    for job in jobs:
        result = run(job, group, device)
        per_rank: List = [None] * world
        dist.all_gather_object(per_rank, result["own"], group=group)
        if rank == 0:
            write_job(out_dir, job, world, device, result, per_rank)
        del result          # its state off the card before the next job


# ---------------------------------------------------------------------------
# Process groups: spawned ranks, or torchrun's
# ---------------------------------------------------------------------------

def _backend(device_type: str) -> str:
    return "gloo" if device_type == "cpu" else "nccl"


def _bind_device(device_type: str, local_rank: int) -> torch.device:
    if device_type == "cpu":
        return torch.device("cpu")
    if local_rank >= torch.cuda.device_count():
        raise RuntimeError(f"rank {local_rank} has no card: "
                           f"{torch.cuda.device_count()} visible")
    torch.cuda.set_device(local_rank)
    return torch.device("cuda", local_rank)


def _spawned_rank(rank: int, world: int, store_path: str, device_type: str,
                  timeout_s: float, fn: Callable, args: tuple) -> None:
    torch.set_num_threads(1)
    device = _bind_device(device_type, rank)
    store = dist.FileStore(store_path, world)
    dist.init_process_group(_backend(device_type), store=store, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))
    try:
        fn(dist.group.WORLD, device, *args)
    finally:
        dist.destroy_process_group()


def _transport_env(device_type: str) -> None:
    """Every rank is on this host: bootstrap over the loopback (a sealed
    host may have no other interface)."""
    var = "GLOO_SOCKET_IFNAME" if device_type == "cpu" else \
        "NCCL_SOCKET_IFNAME"
    os.environ.setdefault(var, "lo")
    if device_type != "cpu":
        os.environ.setdefault("NCCL_DEBUG", "WARN")


def spawn_ranks(fn: Callable, args: tuple, ranks: int, device: str = "cuda",
                timeout_s: float = TIMEOUT_S) -> None:
    """``fn(group, device, *args)`` on each of ``ranks`` spawned processes,
    one card each (``device="cuda"``, NCCL) or on the CPU (gloo). ``fn``
    must be importable by name. Raises if any rank fails."""
    import torch.multiprocessing as mp
    device_type = torch.device(device).type
    if device_type == "cuda" and torch.cuda.device_count() < ranks:
        raise RuntimeError(f"{ranks} ranks need {ranks} cards, "
                           f"{torch.cuda.device_count()} visible")
    _transport_env(device_type)
    with tempfile.TemporaryDirectory(prefix="ranks_") as tmp:
        mp.spawn(_spawned_rank, args=(ranks, os.path.join(tmp, "store"),
                                      device_type, timeout_s, fn, args),
                 nprocs=ranks, join=True)


def launch(jobs: Sequence[Dict], ranks: int, out_dir: str,
           device: str = "cuda", timeout_s: float = TIMEOUT_S) -> None:
    """Run ``jobs`` on ``ranks`` spawned ranks; files under ``out_dir``."""
    spawn_ranks(run_jobs, (list(jobs), out_dir), ranks, device, timeout_s)


def _torchrun_main(jobs: Sequence[Dict], out_dir: str, device_type: str,
                   timeout_s: float) -> None:
    """One rank under torchrun (``env://``: RANK, WORLD_SIZE, LOCAL_RANK,
    MASTER_ADDR and MASTER_PORT from the environment)."""
    torch.set_num_threads(1)
    _transport_env(device_type)
    device = _bind_device(device_type, int(os.environ["LOCAL_RANK"]))
    dist.init_process_group(_backend(device_type), init_method="env://",
                            timeout=datetime.timedelta(seconds=timeout_s))
    try:
        run_jobs(dist.group.WORLD, device, jobs, out_dir)
    finally:
        dist.destroy_process_group()


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--ranks", type=int, default=None,
                    help="ranks to spawn (default: torchrun's, else 1)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--scenario", choices=sorted(SCENARIOS), default="sir")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--agents-per-shard", type=int, default=None)
    ap.add_argument("--shards", type=int, default=None)
    ap.add_argument("--force-impl", default=None)
    ap.add_argument("--plan", default=None,
                    help="a JSON list of jobs (overrides the job flags)")
    ap.add_argument("--out", required=True)
    ap.add_argument("--timeout", type=float, default=TIMEOUT_S,
                    help="seconds a rank waits in a collective")
    args = ap.parse_args(argv)
    if args.plan:
        jobs = json.loads(Path(args.plan).read_text())
    else:
        job = {"scenario": args.scenario, "steps": args.steps}
        for key, val in (("agents_per_shard", args.agents_per_shard),
                         ("n_shards", args.shards),
                         ("force_impl", args.force_impl)):
            if val is not None:
                job[key] = val
        jobs = [job]
    if args.ranks is None and "LOCAL_RANK" in os.environ:
        _torchrun_main(jobs, args.out, args.device, args.timeout)
    else:
        launch(jobs, args.ranks or 1, args.out, args.device, args.timeout)


if __name__ == "__main__":
    main()
