"""Epidemiology (paper Table 1): spatial SIR with random agent movement,
the port's counterpart of examples/epidemiology.py.

Prints the classic SIR curves: neighbor-radius infection over the uniform
grid, no mechanical forces, random-walk movement.

    PYTHONPATH=src python -m repro_torch.examples.epidemiology [--device cpu]

Running distributed
-------------------
The same scenario runs sharded without touching the model: every x-slab
runs the shared iteration core, so behaviors, births and deaths and the
infection state cross slab boundaries on their own. Without ``--ranks``
the port stacks the 4 shards as lanes of one device
(``core/distributed.py``); with ``--ranks N`` it runs N shards, one a
rank of a process group (one a card, or gloo ranks with ``--device
cpu``), through ``launch/distributed.py``:

    PYTHONPATH=src python -m repro_torch.examples.epidemiology --distributed
    PYTHONPATH=src python -m repro_torch.examples.epidemiology \
        --distributed --ranks 4
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..core import (DistConfig, DistributedSimulation, EngineConfig,
                    Simulation)
from ..core.behaviors import (INFECTED, RECOVERED, SUSCEPTIBLE, Infection,
                              RandomWalk)
from ..device import DeviceLike
from ..launch.distributed import spawn_ranks
from ._common import env_int, parser

SIDE = 140.0


def n_agents() -> int:
    return env_int("EXAMPLE_N", 20_000)    # CI smoke caps size


def epochs() -> int:
    return env_int("EXAMPLE_EPOCHS", 10)


def make_config() -> EngineConfig:
    return EngineConfig(capacity=n_agents(), domain_lo=(0, 0, 0),
                        domain_hi=(SIDE,) * 3, interaction_radius=3.0,
                        use_forces=False, query_chunk=4096, max_per_box=32)


def behaviors():
    return [RandomWalk(sigma=0.8),
            Infection(radius=3.0, beta=0.25, recovery_time=40)]


def initial_population(rng, n: int):
    pos = rng.uniform(0, SIDE, (n, 3)).astype(np.float32)
    types = np.zeros(n, np.int32)
    types[:20] = INFECTED
    return pos, types


def _init_kwargs(n: int, types) -> dict:
    return dict(diameter=np.full(n, 1.0, np.float32), agent_type=types,
                extra_init={"infect_timer": np.full(n, 40, np.int32)})


def report(iteration, agent_type, alive):
    t = agent_type[alive].cpu().numpy()
    print(f"{int(iteration):5d} {(t == SUSCEPTIBLE).sum():7d} "
          f"{(t == INFECTED).sum():7d} {(t == RECOVERED).sum():7d}")
    return t


def run_single(device: DeviceLike = None) -> None:
    n = n_agents()
    pos, types = initial_population(np.random.default_rng(1), n)
    sim = Simulation(make_config(), behaviors(), device=device)
    state = sim.init_state(pos, **_init_kwargs(n, types))
    print(f"{'iter':>5} {'S':>7} {'I':>7} {'R':>7}")
    for _ in range(epochs()):
        state = sim.run(state, 20, check_overflow=True)
        t = report(state.iteration, state.pool.agent_type, state.pool.alive)
    assert (t != SUSCEPTIBLE).sum() > 20, "epidemic should have spread"
    print("OK: epidemic spread and recovered")


def main_distributed(n_shards: int = 4, device: DeviceLike = None,
                     group=None) -> None:
    """The distributed path: the same config and behaviors over quantile
    x-slabs with in-loop rebalance. RandomWalk draws per shard, so the
    curves equal the single-device run's statistically, not bit for bit.
    With ``group`` every rank runs this (its block of the shards) and
    rank 0 prints."""
    n = n_agents()
    pos, types = initial_population(np.random.default_rng(1), n)
    local_capacity = 2 * n // n_shards
    dcfg = DistConfig(engine=make_config(), n_shards=n_shards,
                      local_capacity=local_capacity,
                      halo_capacity=min(4096, local_capacity),
                      migrate_capacity=min(2048, local_capacity),
                      rebalance_frequency=10)
    dsim = DistributedSimulation(dcfg, behaviors(), device=device,
                                 group=group)
    state = dsim.init_state(pos, **_init_kwargs(n, types))
    say = group is None or dist.get_rank(group) == 0
    if say:
        print(f"{'iter':>5} {'S':>7} {'I':>7} {'R':>7}   (over {n_shards} "
              f"shards)")
    for _ in range(epochs()):
        state = dsim.run(state, 20, check_overflow=True)
        ch = dsim.gather_channels(state)          # every shard's agents
        live = dsim.global_stats(state.stats).n_live.tolist()
        if say:
            t = report(state.iteration, torch.from_numpy(ch["agent_type"]),
                       torch.from_numpy(ch["alive"]))
            print(f"      per-shard live: {live}")
    t = ch["agent_type"][ch["alive"]]
    assert (t != SUSCEPTIBLE).sum() > 20, "epidemic should have spread"
    if say:
        print("OK: epidemic spread and recovered (distributed)")


def _rank_main(group, device, n_shards: int) -> None:
    main_distributed(n_shards, device, group)


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = parser(__doc__)
    ap.add_argument("--distributed", action="store_true",
                    help="4 x-slab shards stepped together on the device")
    ap.add_argument("--ranks", type=int, default=None,
                    help="with --distributed: one shard a rank, this many "
                         "ranks (one a card; gloo with --device cpu)")
    args = ap.parse_args(argv)
    if args.distributed and args.ranks:
        spawn_ranks(_rank_main, (args.ranks,), args.ranks,
                    args.device or "cuda")
    elif args.distributed:
        main_distributed(device=args.device)
    else:
        run_single(args.device)


if __name__ == "__main__":
    main()
