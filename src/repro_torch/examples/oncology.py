"""Oncology (paper Table 1): tumor spheroid growth with cell death, the
port's counterpart of examples/oncology.py.

Cells divide under mechanical constraints (K1 on the card) and die
stochastically, exercising the parallel removal path (paper §3.2). The run
is driven by the capacity ladder: the pool starts at the seed size and
every capacity (pool slots, grid run width) grows automatically, with a
rewound re-run of the overflowing step, as the population outgrows it.
Then a checkpoint, a restore into a fresh ladder and 10 more steps must
match the uninterrupted run bit for bit.

    PYTHONPATH=src python -m repro_torch.examples.oncology [--device cpu]
"""

from __future__ import annotations

import tempfile
from typing import Optional, Sequence

import numpy as np
import torch

from ..core import (CapacityLadder, EngineConfig, ForceParams, restore_state,
                    save_state)
from ..core.behaviors import GrowDivide, RandomDeath, RandomWalk
from ._common import env_int, parser

N_SEED = 256


def make_config() -> EngineConfig:
    # seed-sized: the ladder grows it
    return EngineConfig(capacity=N_SEED,
                        domain_lo=(0, 0, 0),
                        domain_hi=(160, 160, 160), interaction_radius=14.0,
                        dt=0.2, sort_frequency=10, max_per_box=160,
                        force=ForceParams(max_displacement=1.0))


def behaviors():
    return [GrowDivide(rate=0.7, threshold_diameter=12.0),
            RandomWalk(sigma=0.1),
            RandomDeath(rate=0.012)]


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = parser(__doc__).parse_args(argv)
    rng = np.random.default_rng(3)
    n_seed = N_SEED
    ladder = CapacityLadder(make_config(), behaviors(), device=args.device)
    pos = rng.uniform(55, 105, (n_seed, 3)).astype(np.float32)
    state = ladder.init_state(pos, diameter=np.full(n_seed, 9.0, np.float32))
    print(f"{'iter':>5} {'n_live':>7} {'births':>7} {'deaths':>7} "
          f"{'capacity':>9}")
    for epoch in range(env_int("EXAMPLE_EPOCHS", 6)):
        state = ladder.run(state, 10)
        print(f"{int(state.iteration):5d} {int(state.stats['n_live']):7d} "
              f"{int(state.stats['births']):7d} "
              f"{int(state.stats['deaths']):7d} "
              f"{ladder.config.capacity:9d}")
    alive = state.pool.alive.cpu().numpy()
    n = int(state.stats["n_live"])
    assert alive[:n].all() and not alive[n:].any(), "compaction invariant"
    if int(state.iteration) >= 30:     # first division needs ~22 steps
        assert ladder.rungs, \
            "seed-sized pool should have forced at least one rung"
    print(f"rung schedule: {ladder.rungs}")
    print("OK: tumor grew with concurrent birth/death churn "
          f"({ladder.recompiles} automatic capacity recompiles)")

    # --- checkpoint / resume -------------------------------------------------
    # Save the complete run state (pool, RNG, rung knobs, step index),
    # "crash", restore into a fresh ladder, and verify 10 more steps match
    # the uninterrupted run byte for byte.
    ckpt_dir = tempfile.mkdtemp(prefix="oncology_ckpt_")
    save_state(ckpt_dir, state, ladder.config)
    oracle = ladder.run(state, 10)                 # uninterrupted
    resumed_state, resumed_cfg = restore_state(ckpt_dir, make_config(),
                                               behaviors(),
                                               device=ladder.device)
    resumed = CapacityLadder(resumed_cfg, behaviors(),
                             device=ladder.device).run(resumed_state, 10)
    assert torch.equal(oracle.pool.position, resumed.pool.position), \
        "resumed trajectory must be bit-exact"
    print(f"OK: resumed from {ckpt_dir} at iteration "
          f"{int(resumed.iteration) - 10}, 10 post-resume steps bit-exact")


if __name__ == "__main__":
    main()
