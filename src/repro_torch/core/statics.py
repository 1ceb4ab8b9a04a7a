"""Static-region detection (port of ``repro.core.statics``; paper §5).

An agent is static next iteration iff, in the last one, (i) neither it nor
a neighbor moved, (ii) neither grew, (iii) no agent was born near it, and
(iv) at most one neighbor force on it was non-zero. Conditions i-iii are
evaluated at box granularity: per-agent disturbance is added into the dense
box table, a 3×3×3 windowed OR spreads it to each box's neighborhood, and
one lookup per agent reads it. The box edge is at least the interaction
radius, so this is a conservative superset of the radius test: a static
agent is static under the exact test too. Static rows leave K1's query mask
and drop whole row blocks from its column map.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .agents import AgentPool
from .grid import GridSpec, GridState
from .lanes import Lanes


def _window_or(a: torch.Tensor, axis: int) -> torch.Tensor:
    """OR of each cell with its two neighbors along ``axis`` (edge-clipped)."""
    pad = [0] * (2 * a.dim())
    pad[2 * (a.dim() - 1 - axis)] = pad[2 * (a.dim() - 1 - axis) + 1] = 1
    p = F.pad(a, pad)
    n = a.shape[axis]
    return p.narrow(axis, 0, n) | p.narrow(axis, 1, n) | p.narrow(axis, 2, n)


def neighborhood_disturbed(spec: GridSpec, grid: GridState, pool: AgentPool,
                           iteration: torch.Tensor,
                           lanes: Optional[Lanes] = None) -> torch.Tensor:
    """(M,) bool per box: an agent in its 3×3×3 neighborhood moved or grew
    last iteration, or was born this one.

    Dead slots carry ``DEAD_KEY`` (2**32 - 1 held in int64): keys are
    clamped to ``m`` and added into a table of ``m + 1`` boxes whose last
    entry is cut off, so they drop out as the reference's ``mode="drop"``
    scatter drops them.

    ``lanes``: an ensemble's lane-major pool (its lane-local keys and
    ``iteration`` (L,)): each lane adds into its own table of ``m + 1``
    boxes and the window runs over (L, X, Y, Z); returns (L·M,).
    """
    multi = lanes is not None and not lanes.solo
    if multi:
        iteration = lanes.rows(iteration)
    disturbed = pool.alive & (pool.moved | pool.grew
                              | (pool.born_iter == iteration))
    m = spec.table_size
    n = lanes.n if multi else 1
    box = torch.clamp(grid.keys, max=m)
    if multi:
        box = box + lanes.rows(torch.arange(n, dtype=box.dtype,
                                            device=box.device) * (m + 1))
    per_box = torch.zeros(n * (m + 1), dtype=torch.int32, device=box.device)
    per_box = per_box.index_add(0, box, disturbed.to(torch.int32))
    if multi:
        d3 = (per_box.reshape(n, m + 1)[:, :m] > 0).reshape(n, *spec.dims)
        d3 = _window_or(_window_or(_window_or(d3, 1), 2), 3)
    else:
        d3 = (per_box[:m] > 0).reshape(spec.dims)
        d3 = _window_or(_window_or(_window_or(d3, 0), 1), 2)
    return d3.reshape(-1)


def update_static_flags(pool: AgentPool, spec: GridSpec, grid: GridState,
                        iteration: torch.Tensor,
                        lanes: Optional[Lanes] = None) -> torch.Tensor:
    """``static`` for every slot (paper §5 conditions i-iv): i-iii from the
    box-granular neighborhood, iv from the per-agent ``force_nnz``
    (``lanes``: an ensemble's, each lane over its own boxes)."""
    nbh = neighborhood_disturbed(spec, grid, pool, iteration, lanes)
    box = torch.clamp(grid.keys, max=spec.table_size - 1)
    if lanes is not None and not lanes.solo:
        iteration = lanes.rows(iteration)
        box = box + lanes.rows(torch.arange(
            lanes.n, dtype=box.dtype, device=box.device) * spec.table_size)
    self_ok = ~pool.moved & ~pool.grew & (pool.born_iter != iteration)
    return pool.alive & self_ok & ~nbh[box] & (pool.force_nnz <= 1)
