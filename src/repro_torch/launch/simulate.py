"""ABM simulation driver for the port (counterpart of
``repro.launch.simulate``): the paper's five scenarios, CLI-sized.

    PYTHONPATH=src python -m repro_torch.launch.simulate \
        --scenario epidemiology --agents 100000 --iterations 100
    PYTHONPATH=src python -m repro_torch.launch.simulate --config fig6 \
        --agents 1048576 --iterations 10

Each scenario is set up exactly as the reference's ``build``, densities
included: ``--scenario proliferation`` places about 125 agents per box,
which overflows the 384-agent run capacity at every size (the reference
raises the same error), and ``neuroscience`` crowds its growth cones into
a 20³ region, which overflows from about 6,500 cones on. ``--config
fig6`` takes the Fig-6 proliferation scaling set-up of
``benchmarks/scaling.py`` instead (about one agent per box), and
``--scenario epidemiology --config breakdown`` the forces + SIR workload of
``benchmarks/breakdown.py`` (about four agents per box; forces in K1 and
Infection in the streamed sweep, the two sharing the step's grid tables).
``--force-impl`` picks K1 (default) or the streamed sweep for the set-ups
with forces. ``--pairlist`` serves the breakdown workload from a Verlet
pair list: ``skin0`` rebuilds it every step at the interaction radius
(max_pairs 64, as benchmarks/breakdown.py), ``reuse`` keeps it across
steps under ``RebuildPolicy("every_k", k=8, displacement_bound=0.75)`` with
skin 1.5 (examples/cell_clustering.py's reuse settings), max_pairs sized
from a probe build as benchmarks/capacity.py sizes it. Runs on the CUDA
card unless ``--device cpu`` is given.

Fault-tolerant mode: ``--supervised --ckpt-dir DIR`` runs under the
checkpointing supervisor (``core/simcheck.py``) around a capacity ladder,
so the population grows past the set-up's capacities instead of raising:
atomic checkpoints every ``--checkpoint-every`` steps, health guards,
rollback and degradation on a fault, and a ``run report:`` JSON line at the
end. ``--resume`` restores the latest checkpoint in ``--ckpt-dir`` and runs
``--iterations`` more steps, bit-exact with the uninterrupted run::

    PYTHONPATH=src python -m repro_torch.launch.simulate \
        --scenario proliferation --agents 65536 --iterations 100 \
        --supervised --ckpt-dir /tmp/ck --checkpoint-every 50
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from ..core import (CapacityLadder, DiffusionSpec, EngineConfig, ForceParams,
                    PairListConfig, RebuildPolicy, Simulation,
                    SupervisedRunner, build_env, grid, restore_state)
from ..core.behaviors import (GROWTH_CONE, INFECTED, Chemotaxis, GrowDivide,
                              Infection, NeuriteGrowth, RandomDeath,
                              RandomWalk, Secretion)

SCENARIOS = ("proliferation", "clustering", "epidemiology", "neuroscience",
             "oncology")
CONFIGS = ("cli", "fig6", "breakdown")
# the scenario each non-CLI set-up belongs to
_CONFIG_SCENARIO = {"fig6": "proliferation", "breakdown": "epidemiology"}
FORCE_IMPLS = ("k1", "streamed")
PAIRLIST_MODES = ("off", "skin0", "reuse")


def build(scenario: str, n: int, config: str = "cli", device=None,
          force_impl: str = "k1", pairlist: str = "off"):
    """(Simulation, initial state) for a scenario; data from seed 0."""
    if config not in CONFIGS:
        raise ValueError(f"config must be one of {CONFIGS}, got {config!r}")
    if config != "cli" and scenario != _CONFIG_SCENARIO[config]:
        raise ValueError(f"--config {config} is a set-up of the "
                         f"{_CONFIG_SCENARIO[config]} scenario")
    if pairlist not in PAIRLIST_MODES:
        raise ValueError(f"pairlist must be one of {PAIRLIST_MODES}, got "
                         f"{pairlist!r}")
    if pairlist != "off" and config != "breakdown":
        raise ValueError("--pairlist serves the breakdown workload only")
    if config == "breakdown":
        return _breakdown(n, device, force_impl, pairlist)
    rng = np.random.default_rng(0)
    if config == "fig6":
        # benchmarks/scaling.py: constant density, ~1 agent per box
        side = max(40.0, (n ** (1 / 3)) * 4.0)
        cfg = EngineConfig(capacity=int(n * 1.3), domain_lo=(0, 0, 0),
                           domain_hi=(side,) * 3, interaction_radius=4.0,
                           dt=0.05, max_per_box=32, query_chunk=4096,
                           force_impl=force_impl,
                           force=ForceParams(max_displacement=0.5))
        sim = Simulation(cfg, [GrowDivide(rate=0.01, threshold_diameter=6.0)],
                         device=device)
        pos = rng.uniform(2.0, side - 2.0, (n, 3)).astype(np.float32)
        return sim, sim.init_state(pos, diameter=np.full(n, 3.0, np.float32))
    if scenario == "proliferation":
        side = max(120.0, (n ** (1 / 3)) * 14)
        cfg = EngineConfig(capacity=max(4 * n, 1024), domain_lo=(0,) * 3,
                           domain_hi=(side,) * 3, interaction_radius=14.0,
                           dt=0.2, sort_frequency=10, max_per_box=128,
                           force_impl=force_impl,
                           force=ForceParams(max_displacement=1.0))
        sim = Simulation(cfg, [GrowDivide(rate=0.6, threshold_diameter=12.0)],
                         device=device)
        pos = rng.uniform(side * 0.4, side * 0.6, (n, 3)).astype(np.float32)
        st = sim.init_state(pos, diameter=np.full(n, 8.0, np.float32))
    elif scenario == "clustering":
        side = max(64.0, (n ** (1 / 3)) * 4)
        dim = int(side // 2)
        cfg = EngineConfig(capacity=n, domain_lo=(0,) * 3,
                           domain_hi=(side,) * 3, interaction_radius=3.0,
                           use_forces=False, query_chunk=4096,
                           diffusion=DiffusionSpec(dims=(dim,) * 3,
                                                   coefficient=0.5,
                                                   decay=0.01, voxel=2.0))
        sim = Simulation(cfg, [Secretion(rate=2.0), Chemotaxis(speed=0.35)],
                         device=device)
        pos = rng.uniform(4, side - 4, (n, 3)).astype(np.float32)
        st = sim.init_state(pos, diameter=np.full(n, 1.0, np.float32))
    elif scenario == "epidemiology":
        side = max(100.0, (n ** (1 / 3)) * 5)
        cfg = EngineConfig(capacity=n, domain_lo=(0,) * 3,
                           domain_hi=(side,) * 3, interaction_radius=3.0,
                           use_forces=False, query_chunk=4096)
        sim = Simulation(cfg, [RandomWalk(sigma=0.8),
                               Infection(radius=3.0, beta=0.25,
                                         recovery_time=40)], device=device)
        pos = rng.uniform(0, side, (n, 3)).astype(np.float32)
        types = np.zeros(n, np.int32)
        types[:max(n // 1000, 5)] = INFECTED
        st = sim.init_state(pos, diameter=np.full(n, 1.0, np.float32),
                            agent_type=types,
                            extra_init={"infect_timer":
                                        np.full(n, 40, np.int32)})
    elif scenario == "neuroscience":
        cfg = EngineConfig(capacity=max(40 * n, 2048), domain_lo=(0,) * 3,
                           domain_hi=(160,) * 3, interaction_radius=4.0,
                           dt=0.5, detect_static=True, sort_frequency=20,
                           max_per_box=64, force_impl=force_impl,
                           force=ForceParams(max_displacement=0.2,
                                             move_eps=1e-4))
        sim = Simulation(cfg, [NeuriteGrowth(speed=0.8, noise=0.2,
                                             bifurcation_prob=0.008)],
                         device=device)
        pos = rng.uniform(70, 90, (n, 3)).astype(np.float32)
        d0 = rng.standard_normal((n, 3)).astype(np.float32)
        d0 /= np.linalg.norm(d0, axis=1, keepdims=True)
        st = sim.init_state(pos, diameter=np.full(n, 2.0, np.float32),
                            agent_type=np.full(n, GROWTH_CONE, np.int32),
                            extra_init={"direction": d0})
    elif scenario == "oncology":
        side = max(160.0, (n ** (1 / 3)) * 16)
        cfg = EngineConfig(capacity=max(8 * n, 2048), domain_lo=(0,) * 3,
                           domain_hi=(side,) * 3, interaction_radius=14.0,
                           dt=0.2, sort_frequency=10, max_per_box=160,
                           force_impl=force_impl,
                           force=ForceParams(max_displacement=1.0))
        sim = Simulation(cfg, [GrowDivide(rate=0.7, threshold_diameter=12.0),
                               RandomWalk(sigma=0.1),
                               RandomDeath(rate=0.012)], device=device)
        pos = rng.uniform(side * 0.35, side * 0.65, (n, 3)).astype(np.float32)
        st = sim.init_state(pos, diameter=np.full(n, 9.0, np.float32))
    else:
        raise ValueError(f"scenario must be one of {SCENARIOS}, got "
                         f"{scenario!r}")
    return sim, st


def _breakdown(n: int, device, force_impl: str, pairlist: str = "off"):
    """benchmarks/breakdown.py's workload: ~4 live agents per box, forces
    and SIR infection (two pair kernels), 1% infected, seed 4; with a pair
    list as :func:`build`'s ``pairlist`` says."""
    rng = np.random.default_rng(4)
    side = float(np.ceil(4.0 * (n / 4.0) ** (1.0 / 3.0)))
    cfg = EngineConfig(capacity=n, domain_lo=(0, 0, 0),
                       domain_hi=(side,) * 3, interaction_radius=4.0,
                       dt=0.05, max_per_box=32, query_chunk=4096,
                       force_impl=force_impl,
                       force=ForceParams(max_displacement=0.5))
    if pairlist == "skin0":
        cfg = dataclasses.replace(cfg, pairlist=PairListConfig(
            skin=0.0, max_pairs=64))
    elif pairlist == "reuse":
        cfg = dataclasses.replace(
            cfg, rebuild=RebuildPolicy(mode="every_k", k=8,
                                       displacement_bound=0.75),
            pairlist=PairListConfig(skin=1.5, max_pairs=8))
    behaviors = [Infection(radius=4.0, beta=0.3, recovery_time=40)]
    pos = rng.uniform(2.0, side - 2.0, (n, 3)).astype(np.float32)
    types = np.zeros(n, np.int32)
    types[:max(n // 100, 1)] = INFECTED

    def init(sim):
        return sim.init_state(pos, diameter=np.full(n, 3.0, np.float32),
                              agent_type=types,
                              extra_init={"infect_timer":
                                          np.full(n, 40, np.int32)})
    sim = Simulation(cfg, behaviors, device=device)
    if pairlist == "reuse":
        cfg = dataclasses.replace(cfg, pairlist=dataclasses.replace(
            cfg.pairlist, max_pairs=probe_max_pairs(sim, init(sim))))
        sim = Simulation(cfg, behaviors, device=device)
    return sim, init(sim)


def probe_max_pairs(sim: Simulation, st) -> int:
    """The pair table's width for ``st``, as benchmarks/capacity.py sizes
    it: the demand of a probe build at the configuration's pair radius,
    up to the next power of two, at least 8 (one host read)."""
    cfg = sim.config
    origin = torch.tensor(cfg.domain_lo, dtype=torch.float32,
                          device=sim.device)
    res = build_env(cfg, sim.spec, st.pool, origin, cfg.cell_size)
    probe = grid.build_pairlist(
        sim.spec, res.grid, res.pool.position, res.pool.alive,
        radius=cfg.interaction_radius + cfg.pairlist.skin, max_pairs=8,
        chunk=cfg.query_chunk)
    return max(8, 1 << int(np.ceil(np.log2(max(int(probe.demand), 1)))))


def supervised_run(sim: Simulation, st, iterations: int, ckpt_dir: str,
                   checkpoint_every: int = 50, resume: bool = False):
    """The CLI's ``--supervised``/``--resume`` path: restore the latest
    checkpoint when resuming (its knobs applied), then run ``iterations``
    steps under ``SupervisedRunner(CapacityLadder(...))``. Returns
    ``(state, report, runner)``."""
    cfg, behaviors = sim.config, sim.behaviors
    if resume:
        st, cfg = restore_state(ckpt_dir, cfg, behaviors, device=sim.device)
        print(f"resumed from {ckpt_dir} at iteration {int(st.iteration)}",
              flush=True)
    runner = SupervisedRunner(CapacityLadder(cfg, behaviors,
                                             device=sim.device),
                              ckpt_dir, checkpoint_every=checkpoint_every)
    st, report = runner.run(st, iterations)
    return st, report, runner


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenario", choices=SCENARIOS, default="proliferation")
    ap.add_argument("--config", choices=CONFIGS, default="cli")
    ap.add_argument("--agents", type=int, default=10_000)
    ap.add_argument("--iterations", type=int, default=100)
    ap.add_argument("--force-impl", choices=FORCE_IMPLS, default="k1")
    ap.add_argument("--pairlist", choices=PAIRLIST_MODES, default="off",
                    help="breakdown only: a Verlet pair list (skin0: every "
                         "step; reuse: every_k with skin 1.5)")
    ap.add_argument("--report-every", type=int, default=20)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--supervised", action="store_true",
                    help="run under the fault-tolerant supervisor")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (required with --supervised)")
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true",
                    help="resume from the latest checkpoint in --ckpt-dir")
    args = ap.parse_args(argv)

    if (args.supervised or args.resume) and not args.ckpt_dir:
        raise SystemExit("--supervised/--resume require --ckpt-dir")
    sim, st = build(args.scenario, args.agents, args.config, args.device,
                    args.force_impl, args.pairlist)
    sync = (torch.cuda.synchronize if sim.device.type == "cuda"
            else (lambda: None))
    sync()
    if args.supervised or args.resume:
        t0 = time.perf_counter()
        st, report, _ = supervised_run(sim, st, args.iterations,
                                       args.ckpt_dir, args.checkpoint_every,
                                       args.resume)
        sync()
        dt = time.perf_counter() - t0
        print(f"iter {int(st.iteration):5d}  "
              f"n_live={int(st.stats['n_live']):8d}  "
              f"{args.iterations / dt:6.2f} iter/s  ({sim.device})")
        print("run report: " + json.dumps(report.to_dict()))
        print("done")
        return
    t0 = time.perf_counter()
    done = 0
    while done < args.iterations:
        k = min(args.report_every, args.iterations - done)
        st = sim.run(st, k, check_overflow=True)
        sync()
        done += k
        dt = time.perf_counter() - t0
        n_live = int(st.stats["n_live"])
        print(f"iter {done:5d}  n_live={n_live:8d}  "
              f"n_active={int(st.stats['n_active']):8d}  "
              f"{done / dt:6.2f} iter/s  {n_live * done / dt:,.0f} "
              f"agent·iter/s  rebuilds={int(st.stats['rebuilds'])}  "
              f"pair_demand={int(st.stats['pair_demand'])}  ({sim.device})")
    print("done")


if __name__ == "__main__":
    main()
