"""K1: block-sparse tiled collision force — the CUDA kernel's wrapper and its
plain PyTorch version.

Replaces ``repro/kernels/collision_force.py::collision_force_kernel`` (the
Pallas TPU kernel). The kernel itself is ``csrc/collision_force.cu``; its
header says how the TPU design was translated and what bounds it.

:func:`collision_force` takes ``data_t`` (8, N_pad) f32 rows [x, y, z,
diameter, type, alive, -, -] in grid-key order and ``block_cols``
(N_pad/128, maxb) int32 (ops.build_block_cols) and returns ``out_t`` (4,
N_pad) f32 rows [fx, fy, fz, nnz]. On a CUDA tensor it launches the kernel
(and counts the launch in ``collision_force.launches``); on a CPU tensor it
runs :func:`collision_force_plain`. There is no other path: a failed build
or launch raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import build

BLOCK = 128
ROW_X, ROW_Y, ROW_Z, ROW_DIA, ROW_TYPE, ROW_ALIVE = 0, 1, 2, 3, 4, 5
ROW_FX, ROW_FY, ROW_FZ, ROW_NNZ = 0, 1, 2, 3
MAX_TYPES = 16                       # adhesion table bound (shared memory)
# FP32 operations of the exact arithmetic on one pair, counting each add,
# mul, compare/select, max, sqrt, pow and division as one (the adhesion
# terms add 8 more when a table is given), and of the cheap reject every
# listed pair goes through (csrc/collision_force.cu: dx, dy, dz; d2 as one
# mul and two FMAs, each FMA a mul and an add; R = rho_q + rho_n; R·R; the
# compare): the work units of the bound chip_smoke.py reports.
OPS_PER_PAIR = 40
OPS_PER_PAIR_ADHESION = 8
OPS_TEST = 11
# The reject accepts d2 <= R·R with R the sum of two inflated radii,
# rho = (max(r, 0) + max(a, 0)/2)·REACH_SLACK; any slack >= (1 + 2^-24)^2.5
# / (1 - 2^-24)^6 keeps every pair the exact float32 band test accepts (the
# kernel's header gives the argument). 2^-16 leaves ~30x room.
REACH_SLACK = 1.0 + 2.0 ** -16

_PLAIN_ROW_BLOCKS = 64          # row blocks per chunk of the plain version


def _check(data_t: torch.Tensor, block_cols: torch.Tensor,
           adhesion: Optional[torch.Tensor]) -> None:
    if data_t.dtype != torch.float32 or data_t.dim() != 2 \
            or data_t.shape[0] != 8 or data_t.shape[1] % BLOCK:
        raise ValueError(f"data_t must be (8, N_pad) float32 with N_pad a "
                         f"multiple of {BLOCK}, got {tuple(data_t.shape)} "
                         f"{data_t.dtype}")
    n_rb = data_t.shape[1] // BLOCK
    if block_cols.dtype != torch.int32 or block_cols.dim() != 2 \
            or block_cols.shape[0] != n_rb:
        raise ValueError(f"block_cols must be ({n_rb}, maxb) int32, got "
                         f"{tuple(block_cols.shape)} {block_cols.dtype}")
    if adhesion is not None:
        t = adhesion.shape[0]
        if adhesion.dtype != torch.float32 or adhesion.shape != (t, t) \
                or not 0 < t <= MAX_TYPES:
            raise ValueError(f"adhesion must be (T, T) float32 with "
                             f"T <= {MAX_TYPES}, got {tuple(adhesion.shape)} "
                             f"{adhesion.dtype}")
    for name, x in (("data_t", data_t), ("block_cols", block_cols),
                    ("adhesion", adhesion)):
        if x is not None and x.device != data_t.device:
            raise ValueError(f"{name} is on {x.device}, data_t on "
                             f"{data_t.device}")


def collision_force(data_t: torch.Tensor, block_cols: torch.Tensor, *,
                    k_rep: float, adhesion: Optional[torch.Tensor],
                    adhesion_band: float) -> torch.Tensor:
    """K1 on ``data_t``'s device: the CUDA kernel for a CUDA tensor, the
    plain version for a CPU tensor. ``adhesion``: (T, T) f32 or None."""
    _check(data_t, block_cols, adhesion)
    if data_t.device.type == "cpu":
        return collision_force_plain(data_t, block_cols, k_rep=k_rep,
                                     adhesion=adhesion,
                                     adhesion_band=adhesion_band)
    if data_t.device.type != "cuda":
        raise ValueError(f"K1 runs on CUDA or CPU tensors, not "
                         f"{data_t.device}")
    n_pad = data_t.shape[1]
    if 8 * n_pad >= 2 ** 31:
        raise ValueError(f"N_pad={n_pad} overflows the kernel's int32 "
                         f"indexing")
    data_t = data_t.contiguous()
    if data_t.data_ptr() % 16:
        raise ValueError("data_t must be 16-byte aligned (cp.async tiles)")
    block_cols = block_cols.contiguous()
    adh = None if adhesion is None else adhesion.contiguous()
    out = torch.empty((4, n_pad), dtype=torch.float32, device=data_t.device)
    fn = _kernel_fn()
    with torch.cuda.device(data_t.device):
        stream = torch.cuda.current_stream(data_t.device).cuda_stream
        err = fn(data_t.data_ptr(), n_pad, block_cols.data_ptr(),
                 block_cols.shape[1], 0 if adh is None else adh.data_ptr(),
                 0 if adh is None else adh.shape[0], k_rep, adhesion_band,
                 REACH_SLACK, out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"K1 collision_force launch failed: CUDA error "
                           f"{err}")
    collision_force.launches += 1
    return out


collision_force.launches = 0


# k1_collision_force(data, n_pad, block_cols, maxb, adhesion, n_types,
#                    k_rep, adhesion_band, reach_slack, out, stream)
ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_float,
            ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p]


def _kernel_fn():
    lib = build.load("collision_force")
    fn = lib.k1_collision_force
    fn.argtypes = ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _listed_tiles(data_t: torch.Tensor, block_cols: torch.Tensor):
    """Chunks of ``_PLAIN_ROW_BLOCKS`` row blocks with their listed column
    blocks gathered (cut to the chunk's longest list): yields ``(the
    chunk's row slice, rowv (8, R, 128, 1), colv (8, R, 1, W·128), same
    (R, 128, W·128): row and candidate are one agent, listed (R, 1,
    W·128))``. Reads each chunk's list length on the host (one sync a
    chunk)."""
    n_rb = block_cols.shape[0]
    dev = data_t.device
    lane = torch.arange(BLOCK, device=dev)
    n_listed = (block_cols >= 0).sum(1)
    for r0 in range(0, n_rb, _PLAIN_ROW_BLOCKS):
        r1 = min(r0 + _PLAIN_ROW_BLOCKS, n_rb)
        width = int(n_listed[r0:r1].max())
        if width == 0:
            continue
        cols = block_cols[r0:r1, :width].long()               # (R, W)
        listed = cols >= 0
        col_ids = cols.clamp(min=0)[..., None] * BLOCK + lane  # (R, W, 128)
        row_ids = (torch.arange(r0, r1, device=dev)[:, None] * BLOCK
                   + lane)                                    # (R, 128)
        rows = data_t[:, r0 * BLOCK:r1 * BLOCK].reshape(8, r1 - r0, BLOCK)
        colv = data_t[:, col_ids.reshape(-1)].reshape(8, r1 - r0, 1,
                                                      width * BLOCK)
        same = row_ids[..., None] == col_ids.reshape(r1 - r0, 1, -1)
        yield (slice(r0 * BLOCK, r1 * BLOCK), rows[..., None], colv, same,
               listed.repeat_interleave(BLOCK, 1)[:, None, :])


def _band(rowv: torch.Tensor, colv: torch.Tensor, adhesion_band: float):
    """dx, dy, dz, dist, r_q, r_n, delta and the band test of every pair,
    in the kernel's float32 arithmetic."""
    dx = colv[ROW_X] - rowv[ROW_X]                        # (R, 128, W·128)
    dy = colv[ROW_Y] - rowv[ROW_Y]
    dz = colv[ROW_Z] - rowv[ROW_Z]
    dist = torch.sqrt(torch.clamp(dx * dx + dy * dy + dz * dz, min=1e-18))
    r_q = rowv[ROW_DIA] * 0.5
    r_n = colv[ROW_DIA] * 0.5
    delta = r_q + r_n - dist
    return dx, dy, dz, dist, r_q, r_n, delta, delta + adhesion_band > 0.0


def collision_force_plain(data_t: torch.Tensor, block_cols: torch.Tensor, *,
                          k_rep: float, adhesion: Optional[torch.Tensor],
                          adhesion_band: float) -> torch.Tensor:
    """Plain PyTorch K1 with the kernel's tile semantics, on any device.

    Chunks of ``_PLAIN_ROW_BLOCKS`` row blocks gather their listed column
    blocks and evaluate every (row, candidate) pair of those tiles at once;
    unlisted (-1) tiles contribute nothing.
    """
    _check(data_t, block_cols, adhesion)
    dev = data_t.device
    out = torch.zeros((4, data_t.shape[1]), dtype=torch.float32, device=dev)
    for sl, rowv, colv, same, listed in _listed_tiles(data_t, block_cols):
        dx, dy, dz, dist, r_q, r_n, delta, in_band = _band(rowv, colv,
                                                           adhesion_band)
        r_eff = torch.clamp(r_q * r_n / torch.clamp(r_q + r_n, min=1e-12),
                            min=1e-12)
        f_mag = k_rep * torch.sqrt(r_eff) * torch.pow(
            torch.clamp(delta, min=0.0), 1.5)
        if adhesion is not None:
            t = adhesion.shape[0]
            ti = rowv[ROW_TYPE].long()
            tj = colv[ROW_TYPE].long()
            ok = (ti >= 0) & (ti < t) & (tj >= 0) & (tj < t)
            mu = torch.where(ok, adhesion.reshape(-1)[
                (ti.clamp(0, t - 1) * t + tj.clamp(0, t - 1))],
                torch.zeros((), device=dev))
            band = torch.clamp(delta + adhesion_band, min=0.0)
            f_mag = f_mag - torch.where(in_band, mu * torch.sqrt(r_eff * band),
                                        torch.zeros((), device=dev))
        valid = ((rowv[ROW_ALIVE] > 0.5) & (colv[ROW_ALIVE] > 0.5) & ~same
                 & listed & in_band)
        f = torch.where(valid, -f_mag, torch.zeros((), device=dev))
        inv = 1.0 / dist
        out[ROW_FX, sl] = (f * dx * inv).sum(-1).reshape(-1)
        out[ROW_FY, sl] = (f * dy * inv).sum(-1).reshape(-1)
        out[ROW_FZ, sl] = (f * dz * inv).sum(-1).reshape(-1)
        out[ROW_NNZ, sl] = (f * f > 1e-14).sum(-1).reshape(-1).to(
            torch.float32)
    return out


def pairs_in_reach(data_t: torch.Tensor, block_cols: torch.Tensor, *,
                   adhesion_band: float) -> int:
    """Listed (row, candidate) pairs that reach the kernel's exact
    arithmetic: both alive and inside the exact float32 band test (self
    pairs included). The work unit of K1's bound beside the listed pairs."""
    n = 0
    for _, rowv, colv, _, listed in _listed_tiles(data_t, block_cols):
        in_band = _band(rowv, colv, adhesion_band)[-1]
        n += int((in_band & listed & (rowv[ROW_ALIVE] > 0.5)
                  & (colv[ROW_ALIVE] > 0.5)).sum())
    return n
