"""Cell clustering (paper Table 1): chemotaxis toward a self-secreted
substance, the port's counterpart of examples/cell_clustering.py.

Agents secrete a diffusing chemoattractant (the secretion kernel on the
card) and climb its gradient. Mean pairwise distance shrinks as clusters
form.

    PYTHONPATH=src python -m repro_torch.examples.cell_clustering \
        [--pairlist] [--device cpu]

``--pairlist`` adds contact mechanics served from the Verlet pair-list
cache: the grid rebuild is amortized every k steps and K1 runs over the
column map of the pruned in-range(+skin) pair table (both built by their
kernels on the card), reused while no agent moves farther than
``--skin``/2. Each epoch prints the listed pairs per agent.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from ..core import (DiffusionSpec, EngineConfig, ForceParams, PairListConfig,
                    RebuildPolicy, Simulation)
from ..core.behaviors import Chemotaxis, Secretion
from ._common import env_int, parser

SIDE = 64.0


def mean_pairwise(p, k=512):
    idx = np.random.default_rng(0).choice(len(p), size=min(k, len(p)),
                                          replace=False)
    q = p[idx]
    d = np.sqrt(((q[:, None] - q[None]) ** 2).sum(-1))
    return d[np.triu_indices(len(q), 1)].mean()


def n_agents() -> int:
    return env_int("EXAMPLE_N", 4_000)     # CI smoke caps size


def make_config(pairlist: bool = False, skin: float = 1.5) -> EngineConfig:
    extra = dict(use_forces=False)
    if pairlist:
        extra = dict(
            use_forces=True,
            # cap the per-step contact resolution so motion stays inside the
            # skin budget (reuse requires max step distance <= skin/2)
            force=ForceParams(max_displacement=0.25),
            rebuild=RebuildPolicy(mode="every_k", k=8,
                                  displacement_bound=skin / 2),
            pairlist=PairListConfig(skin=skin, max_pairs=64))
    return EngineConfig(
        capacity=n_agents(), domain_lo=(0, 0, 0), domain_hi=(SIDE,) * 3,
        interaction_radius=3.0, query_chunk=4096,
        diffusion=DiffusionSpec(dims=(32, 32, 32), coefficient=0.5,
                                decay=0.01, voxel=2.0), **extra)


def behaviors():
    return [Secretion(rate=2.0), Chemotaxis(speed=0.35)]


def pairs_per_agent(state) -> float:
    """Mean listed in-range(+skin) candidates per live agent: resident
    rows of the cached pair table, averaged over the live mask."""
    alive = state.pool.alive.cpu().numpy()
    count = state.env.pairs.count.cpu().numpy()
    n_live = max(int(alive.sum()), 1)
    return float(count[alive].sum()) / n_live


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = parser(__doc__)
    ap.add_argument("--pairlist", action="store_true",
                    help="contact forces via the Verlet pair-list cache")
    ap.add_argument("--skin", type=float, default=1.5,
                    help="pair-list skin (reuse while motion <= skin/2)")
    args = ap.parse_args(argv)
    rng = np.random.default_rng(4)
    n = n_agents()
    epochs = env_int("EXAMPLE_EPOCHS", 6)
    side = SIDE
    sim = Simulation(make_config(args.pairlist, args.skin), behaviors(),
                     device=args.device)
    pos = rng.uniform(4, side - 4, (n, 3)).astype(np.float32)
    dia = 2.0 if args.pairlist else 1.0
    state = sim.init_state(pos, diameter=np.full(n, dia, np.float32))
    p0 = state.pool.position[:n].cpu().numpy()
    print(f"initial mean pairwise distance: {mean_pairwise(p0):.2f}")
    for epoch in range(epochs):
        if args.pairlist:
            skips = 0
            for _ in range(10):
                state = sim.run(state, 1, check_overflow=True)
                skips += int(state.stats.rebuild_skips)
            pl = (f"  pairs/agent {pairs_per_agent(state):.1f}"
                  f"  reused {skips}/10 steps")
        else:
            state = sim.run(state, 10, check_overflow=True)
            pl = ""
        p = state.pool.position[:n].cpu().numpy()
        print(f"iter {int(state.iteration):3d}: mean pairwise "
              f"{mean_pairwise(p):.2f}  substance max "
              f"{float(state.conc.max()):.1f}{pl}")
    assert mean_pairwise(state.pool.position[:n].cpu().numpy()) \
        < mean_pairwise(p0)
    print("OK: clusters formed")


if __name__ == "__main__":
    main()
