"""Row-major linear cell keys for the uniform grid (port of the grid-indexing
half of ``repro.core.morton``; the Morton-order keys of the scatter/hash
environments come with ROADMAP.md Queue 1 item 12).

Keys are int64 tensors holding uint32 values; ``DEAD_KEY`` = 2**32 - 1 sorts
after every box id, so the grid sort doubles as dead-slot compaction.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

DEAD_KEY = 0xFFFFFFFF


def cell_of(position: torch.Tensor, origin: torch.Tensor, box_size: float,
            dims: Tuple[int, int, int]) -> torch.Tensor:
    """Integer cell coordinates (..., 3) int32, clipped into the grid.

    Multiplies by the float32 reciprocal of ``box_size`` instead of dividing:
    the reference engine passes ``box_size`` into its jitted core as a
    constant, and XLA rewrites ``x / c`` to ``x * (1/c)`` for a constant
    ``c``. The two can floor differently for a position on a box boundary
    (about 1 agent in 2M at box 14), and one agent in another box changes
    the whole permutation — so the port reproduces the engine's rounding.
    """
    recip = float(np.float32(1.0) / np.float32(box_size))   # exact in f32
    rel = (position - origin) * recip
    cell = torch.clamp(torch.floor(rel).to(torch.int32), min=0)
    # clipped axis by axis: a bounds tensor made on the host would cost a
    # copy to the card, which waits for the device, on every call
    return torch.stack([cell[..., i].clamp(max=d - 1)
                        for i, d in enumerate(dims)], -1)


def linear_size(dims: Tuple[int, int, int]) -> int:
    """Size of the dense linear-key table: exactly ``prod(dims)`` boxes."""
    n = dims[0] * dims[1] * dims[2]
    if n >= 2 ** 31:
        raise ValueError(f"grid {dims} has {n} boxes > int32 key space")
    return n


def linear_encode3(ix: torch.Tensor, iy: torch.Tensor, iz: torch.Tensor,
                   dims: Tuple[int, int, int]) -> torch.Tensor:
    """Row-major box id with z fastest-varying (int64 holding uint32)."""
    ix, iy, iz = (t.to(torch.int64) & DEAD_KEY for t in (ix, iy, iz))
    return ((ix * dims[1] + iy) * dims[2] + iz) & DEAD_KEY


def linear_keys(position: torch.Tensor, origin: torch.Tensor,
                box_size: float, dims: Tuple[int, int, int]) -> torch.Tensor:
    """Linear box id per agent — the grid sort key."""
    cell = cell_of(position, origin, box_size, dims)
    return linear_encode3(cell[..., 0], cell[..., 1], cell[..., 2], dims)


def grid_sort_keys(position: torch.Tensor, alive: torch.Tensor,
                   origin: torch.Tensor, box_size: float,
                   dims: Tuple[int, int, int]) -> torch.Tensor:
    """Resident-layout sort key: linear box id, dead slots → ``DEAD_KEY``."""
    keys = linear_keys(position, origin, box_size, dims)
    return torch.where(alive, keys, torch.full_like(keys, DEAD_KEY))
