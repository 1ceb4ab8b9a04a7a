"""Neuroscience (paper Table 1 + §5): neurite growth with static regions,
the port's counterpart of examples/neuroscience.py.

Growth cones extend and bifurcate, depositing a trail of segments. The
static-region detection (paper §5) freezes the trail, so K1 computes forces
only for the active front: n_active stays far below n_live.

    PYTHONPATH=src python -m repro_torch.examples.neuroscience [--device cpu]
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from ..core import EngineConfig, ForceParams, Simulation
from ..core.behaviors import GROWTH_CONE, NeuriteGrowth
from ._common import env_int, parser


def make_config() -> EngineConfig:
    return EngineConfig(capacity=16384, domain_lo=(0, 0, 0),
                        domain_hi=(120, 120, 120), interaction_radius=4.0,
                        dt=0.5, detect_static=True, sort_frequency=20,
                        max_per_box=64,
                        force=ForceParams(max_displacement=0.2, move_eps=1e-4))


def behaviors():
    return [NeuriteGrowth(speed=0.8, noise=0.2,
                          bifurcation_prob=0.01,
                          segment_every=2.0)]


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = parser(__doc__).parse_args(argv)
    rng = np.random.default_rng(2)
    n_cones = 64
    sim = Simulation(make_config(), behaviors(), device=args.device)
    pos = rng.uniform(55, 65, (n_cones, 3)).astype(np.float32)
    d0 = rng.standard_normal((n_cones, 3)).astype(np.float32)
    d0 /= np.linalg.norm(d0, axis=1, keepdims=True)
    state = sim.init_state(pos, diameter=np.full(n_cones, 2.0, np.float32),
                           agent_type=np.full(n_cones, GROWTH_CONE, np.int32),
                           extra_init={"direction": d0})
    epochs = env_int("EXAMPLE_EPOCHS", 10)
    print(f"{'iter':>5} {'n_live':>7} {'n_active':>9} {'active%':>8}")
    for epoch in range(epochs):
        state = sim.run(state, 10, check_overflow=True)
        live = int(state.stats["n_live"])
        act = int(state.stats["n_active"])
        print(f"{int(state.iteration):5d} {live:7d} {act:9d} "
              f"{act / max(live, 1):8.1%}")
    live, act = int(state.stats["n_live"]), int(state.stats["n_active"])
    assert live > n_cones * 5, "neurites should have grown"
    assert act < live, "trail should be static (paper §5)"
    print("OK: active growth front << total agents")


if __name__ == "__main__":
    main()
