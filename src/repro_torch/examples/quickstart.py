"""Quickstart: cell proliferation (the paper's first benchmark simulation),
the port's counterpart of examples/quickstart.py.

A cluster of cells grows and divides under mechanical collision forces,
computed by K1 on the card.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from ..core import EngineConfig, ForceParams, Simulation
from ..core.behaviors import GrowDivide
from ._common import env_int, parser


def make_config() -> EngineConfig:
    return EngineConfig(
        capacity=32768,
        domain_lo=(0, 0, 0), domain_hi=(120, 120, 120),
        interaction_radius=14.0,
        dt=0.2,
        sort_frequency=10,              # paper §4.2 memory layout
        max_per_box=64,
        force=ForceParams(max_displacement=1.0),
    )


def behaviors():
    return [GrowDivide(rate=1.0, threshold_diameter=12.0)]


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = parser(__doc__).parse_args(argv)
    rng = np.random.default_rng(0)
    sim = Simulation(make_config(), behaviors(), device=args.device)
    pos = rng.uniform(50, 70, (128, 3)).astype(np.float32)
    state = sim.init_state(pos, diameter=np.full(128, 8.0, np.float32))

    for epoch in range(env_int("EXAMPLE_EPOCHS", 6)):
        state = sim.run(state, 10, check_overflow=True)
        print(f"iter {int(state.iteration):3d}: "
              f"n_live={int(state.stats['n_live']):5d} "
              f"births={int(state.stats['births'])}")
    assert int(state.stats["n_live"]) > 128
    print("OK: population grew under mechanical constraints")


if __name__ == "__main__":
    main()
