"""Cell keys (port of ``repro.core.morton``): row-major linear codes that
index the grid, and Morton (Z-order) codes for the paper's §4.2 agent
sort, which the scatter and hash environments run every
``sort_frequency`` steps.

Keys are int64 tensors holding uint32 values, every bit trick masked to 32
bits; ``DEAD_KEY`` = 2**32 - 1 sorts after every box id, so the grid sort
doubles as dead-slot compaction.
"""

from __future__ import annotations

from typing import Tuple, Union

import numpy as np
import torch

MAX_BITS_3D = 10
MAX_BITS_2D = 16
DEAD_KEY = 0xFFFFFFFF


_U32 = 0xFFFFFFFF


def _u32(x) -> torch.Tensor:
    return torch.as_tensor(x).to(torch.int64) & _U32


def part1by2(x) -> torch.Tensor:
    """Spread the low 10 bits of ``x`` with two zero bits between each."""
    x = _u32(x) & 0x3FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def compact1by2(x) -> torch.Tensor:
    """Inverse of :func:`part1by2` (keeps every third bit)."""
    x = _u32(x) & 0x09249249
    x = (x ^ (x >> 2)) & 0x030C30C3
    x = (x ^ (x >> 4)) & 0x0300F00F
    x = (x ^ (x >> 8)) & 0x030000FF
    x = (x ^ (x >> 16)) & 0x000003FF
    return x


def part1by1(x) -> torch.Tensor:
    """Spread the low 16 bits of ``x`` with one zero bit between each."""
    x = _u32(x) & 0xFFFF
    x = (x | (x << 8)) & 0x00FF00FF
    x = (x | (x << 4)) & 0x0F0F0F0F
    x = (x | (x << 2)) & 0x33333333
    x = (x | (x << 1)) & 0x55555555
    return x


def compact1by1(x) -> torch.Tensor:
    """Inverse of :func:`part1by1`."""
    x = _u32(x) & 0x55555555
    x = (x ^ (x >> 1)) & 0x33333333
    x = (x ^ (x >> 2)) & 0x0F0F0F0F
    x = (x ^ (x >> 4)) & 0x00FF00FF
    x = (x ^ (x >> 8)) & 0x0000FFFF
    return x


def encode3(ix, iy, iz) -> torch.Tensor:
    """3-D Morton code of cell coordinates (each < 2**10)."""
    return (part1by2(ix) | (part1by2(iy) << 1) | (part1by2(iz) << 2)) & _U32


def decode3(code) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Inverse of :func:`encode3` → (ix, iy, iz)."""
    code = _u32(code)
    return compact1by2(code), compact1by2(code >> 1), compact1by2(code >> 2)


def encode2(ix, iy) -> torch.Tensor:
    """2-D Morton code of cell coordinates (each < 2**16)."""
    return (part1by1(ix) | (part1by1(iy) << 1)) & _U32


def decode2(code) -> Tuple[torch.Tensor, torch.Tensor]:
    code = _u32(code)
    return compact1by1(code), compact1by1(code >> 1)


BoxSize = Union[float, torch.Tensor]


def cell_of(position: torch.Tensor, origin: torch.Tensor, box_size: BoxSize,
            dims: Tuple[int, int, int]) -> torch.Tensor:
    """Integer cell coordinates (..., 3) int32, clipped into the grid.

    The reference divides by the box size, and XLA rounds that division in
    one of two ways, which can floor differently for a position on a box
    boundary (72.0 / 4.8 floors to 14, 72.0 · float32(1/4.8) to 15), so
    one agent lands in another box. The port follows it by the type of
    ``box_size``:

    - a Python float is a constant of the reference's jitted program (the
      engine's own box size, the builds of a step): XLA rewrites ``x / c``
      to ``x * (1/c)``, so the port multiplies by the float32 reciprocal;
    - a tensor is a traced value (the cached grid's box size that every_k
      queries read through ``lax.cond``, or an array passed to an eager
      call): XLA really divides, and so does the port.
    """
    if isinstance(box_size, torch.Tensor):
        rel = (position - origin) / box_size
    else:
        recip = float(np.float32(1.0) / np.float32(box_size))  # exact in f32
        rel = (position - origin) * recip
    cell = torch.clamp(torch.floor(rel).to(torch.int32), min=0)
    # clipped axis by axis: a bounds tensor made on the host would cost a
    # copy to the card, which waits for the device, on every call
    return torch.stack([cell[..., i].clamp(max=d - 1)
                        for i, d in enumerate(dims)], -1)


def morton_keys(position: torch.Tensor, origin: torch.Tensor,
                box_size: BoxSize, dims: Tuple[int, int, int]
                ) -> torch.Tensor:
    """Morton sort key per agent — the §4.2 memory-layout sort only; agents
    of one box share a key."""
    cell = cell_of(position, origin, box_size, dims)
    return encode3(cell[..., 0], cell[..., 1], cell[..., 2])


def code_space_size(dims: Tuple[int, int, int]) -> int:
    """Size of a dense Morton-indexed table over ``dims``: the cube of the
    next power of two of ``max(dims)``."""
    m = max(dims)
    bits = max(1, (m - 1).bit_length())
    if bits > MAX_BITS_3D:
        raise ValueError(f"grid dim {m} needs {bits} bits/axis > {MAX_BITS_3D}")
    return 1 << (3 * bits)


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


def linear_decode3(code, dims: Tuple[int, int, int]
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Inverse of :func:`linear_encode3` → (ix, iy, iz)."""
    code = _u32(code)
    iz = code % dims[2]
    rest = torch.div(code, dims[2], rounding_mode="floor")
    return torch.div(rest, dims[1], rounding_mode="floor"), rest % dims[1], iz


def linear_keys(position: torch.Tensor, origin: torch.Tensor,
                box_size: BoxSize, dims: Tuple[int, int, int]) -> torch.Tensor:
    """Linear box id per agent — the grid sort key."""
    cell = cell_of(position, origin, box_size, dims)
    return linear_encode3(cell[..., 0], cell[..., 1], cell[..., 2], dims)


def grid_sort_keys(position: torch.Tensor, alive: torch.Tensor,
                   origin: torch.Tensor, box_size: BoxSize,
                   dims: Tuple[int, int, int]) -> torch.Tensor:
    """Resident-layout sort key: linear box id, dead slots → ``DEAD_KEY``."""
    keys = linear_keys(position, origin, box_size, dims)
    return torch.where(alive, keys, torch.full_like(keys, DEAD_KEY))
