"""ABM simulation driver for the port (counterpart of
``repro.launch.simulate``).

    PYTHONPATH=src python -m repro_torch.launch.simulate --config fig6 \
        --agents 1048576 --iterations 10

``--scenario proliferation`` mirrors the reference CLI's set-up exactly,
including its density: about 125 agents per box, which overflows the
384-agent run capacity at every size (the reference raises the same
error). ``--config fig6`` takes the Fig-6 proliferation scaling set-up of
``benchmarks/scaling.py`` instead (about one agent per box). The other
scenarios are not ported yet (ROADMAP.md Queue 1 item 10). Runs on the CUDA
card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..core import EngineConfig, ForceParams, Simulation
from ..core.behaviors import GrowDivide

SCENARIOS = ("proliferation", "clustering", "epidemiology", "neuroscience",
             "oncology")
CONFIGS = ("cli", "fig6")


def build(scenario: str, n: int, config: str = "cli", device=None):
    """(Simulation, initial state) for a scenario; positions from seed 0."""
    if scenario != "proliferation":
        raise NotImplementedError(
            f"scenario {scenario!r} is not ported yet (ROADMAP.md Queue 1 "
            f"item 10)")
    rng = np.random.default_rng(0)
    if config == "fig6":
        # benchmarks/scaling.py: constant density, ~1 agent per box
        side = max(40.0, (n ** (1 / 3)) * 4.0)
        cfg = EngineConfig(capacity=int(n * 1.3), domain_lo=(0, 0, 0),
                           domain_hi=(side,) * 3, interaction_radius=4.0,
                           dt=0.05, max_per_box=32, query_chunk=4096,
                           force=ForceParams(max_displacement=0.5))
        sim = Simulation(cfg, [GrowDivide(rate=0.01, threshold_diameter=6.0)],
                         device=device)
        pos = rng.uniform(2.0, side - 2.0, (n, 3)).astype(np.float32)
        return sim, sim.init_state(pos, diameter=np.full(n, 3.0, np.float32))
    if config != "cli":
        raise ValueError(f"config must be one of {CONFIGS}, got {config!r}")
    side = max(120.0, (n ** (1 / 3)) * 14)
    cfg = EngineConfig(capacity=max(4 * n, 1024), domain_lo=(0,) * 3,
                       domain_hi=(side,) * 3, interaction_radius=14.0,
                       dt=0.2, sort_frequency=10, max_per_box=128,
                       force=ForceParams(max_displacement=1.0))
    sim = Simulation(cfg, [GrowDivide(rate=0.6, threshold_diameter=12.0)],
                     device=device)
    pos = rng.uniform(side * 0.4, side * 0.6, (n, 3)).astype(np.float32)
    return sim, sim.init_state(pos, diameter=np.full(n, 8.0, np.float32))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenario", choices=SCENARIOS, default="proliferation")
    ap.add_argument("--config", choices=CONFIGS, default="cli")
    ap.add_argument("--agents", type=int, default=10_000)
    ap.add_argument("--iterations", type=int, default=100)
    ap.add_argument("--report-every", type=int, default=20)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args()

    sim, st = build(args.scenario, args.agents, args.config, args.device)
    sync = (torch.cuda.synchronize if sim.device.type == "cuda"
            else (lambda: None))
    sync()
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
              f"agent·iter/s  ({sim.device})")
    print("done")


if __name__ == "__main__":
    main()
