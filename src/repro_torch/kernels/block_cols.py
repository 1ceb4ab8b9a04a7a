"""K1's column map on the card: the CUDA kernel's wrapper.

``csrc/block_cols.cu`` builds the block-sparse column map that
``ops.build_block_cols`` defines (its header says how), and in the same
launch can do what precedes the map in ``ops.k1_inputs``: the cells of the
rows, the row mask and the pack of K1's data rows. :func:`column_map` is the
one function that launches it (counted in ``column_map.launches``); the
plain versions are ``ops.build_block_cols_plain`` and
``ops.k1_inputs_plain``, which ``ops`` runs for CPU tensors. There is no
other path: a failed build or launch raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from . import build

BLOCK = 128
# Integer operations per row in csrc/block_cols.cu, each counted once: per
# stencil column 44 (indices, the inside test, clamps, the linear box id,
# run length, first and last block, the span test, the interval and the
# keep test), 9 columns, plus 19 for the cell and the z-run ends. Loads and
# the per-block rank and sweep (which depend on the data) are not counted:
# the work unit of the bound chip_smoke.py reports.
OPS_PER_ROW = 9 * 44 + 19

# k1_block_cols(cells, row_active, position, diameter, agent_type, alive,
#               active, n_rows, origin, recip, starts, counts, n_pad, dim_x,
#               dim_y, dim_z, maxb, span, lane_rows, lane_stride, block_cols,
#               overflow, data_t, row_mask, stream)
ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_float,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]

Pool = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
             torch.Tensor]


def _kernel_fn():
    lib = build.load("block_cols")
    fn = lib.k1_block_cols
    fn.argtypes = ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _ptr(x: Optional[torch.Tensor]) -> int:
    return 0 if x is None else x.data_ptr()


def column_map(starts: torch.Tensor, counts: torch.Tensor,
               dims: Tuple[int, int, int], maxb: int, span: int, *,
               n_pad: int, cells: Optional[torch.Tensor] = None,
               row_active: Optional[torch.Tensor] = None,
               pool: Optional[Pool] = None,
               origin: Optional[torch.Tensor] = None,
               box_size: Optional[float] = None, lanes: int = 1,
               lane_rows: Optional[int] = None):
    """The column map of ``n_pad`` rows on the card, from ``cells`` (n_pad,
    3) int32 and ``row_active`` (n_pad,) bool, or from ``pool`` = (position
    (C, 3) f32, diameter (C,) f32, agent_type (C,) int, alive (C,) bool,
    active (C,) bool) with ``origin`` (3,) and ``box_size``.

    ``lanes`` > 1 maps an ensemble in the same launch: the pool holds
    ``lanes`` lanes of C / lanes rows, packed at a stride of n_pad / lanes
    rows (a multiple of 128) so that no row block holds two lanes, and
    ``starts``/``counts`` are the lanes' tables one after another (slot ids
    of the whole pool). Column ids are packed blocks of the row block's own
    lane, and the overflow is per lane. With ``cells`` (packed rows) the
    pool's rows per lane come as ``lane_rows``.

    Returns ``(block_cols (n_pad/128, maxb) int32, overflow () bool — (L,)
    for lanes, data_t (8, n_pad) f32 or None, row mask (n_pad,) bool or
    None)`` — the last two only from a pool.
    """
    dev = starts.device
    if dev.type != "cuda":
        raise ValueError(f"the column-map kernel runs on CUDA tensors, not "
                         f"{dev}")
    if (cells is None) == (pool is None):
        raise ValueError("give either cells and row_active, or a pool")
    if n_pad % BLOCK or 8 * n_pad >= 2 ** 31:
        raise ValueError(f"n_pad={n_pad} must be a multiple of {BLOCK} "
                         f"below 2^28")
    if dims[0] * dims[1] * dims[2] >= 2 ** 31 or min(dims) < 1:
        raise ValueError(f"grid {dims} does not fit int32 box ids")
    if maxb < 0 or span < 1:
        raise ValueError(f"maxb={maxb}, span={span}")
    if lanes < 1 or n_pad % (lanes * BLOCK):
        raise ValueError(f"n_pad={n_pad} must pack {lanes} lanes at whole "
                         f"{BLOCK}-row blocks")
    m = dims[0] * dims[1] * dims[2]
    if lanes * m >= 2 ** 31:
        raise ValueError(f"{lanes} tables of {m} boxes overflow int32")
    starts = starts.to(torch.int32).contiguous()
    counts = counts.to(torch.int32).contiguous()
    if starts.shape != (lanes * m,) or counts.shape != (lanes * m,):
        raise ValueError(f"starts/counts must be ({lanes * m},), got "
                         f"{tuple(starts.shape)}, {tuple(counts.shape)}")
    lane_stride = n_pad // lanes
    data_t = mask = position = diameter = agent_type = alive = active = None
    recip, n_rows = 0.0, 0
    if cells is not None:
        if cells.shape != (n_pad, 3) or row_active is None \
                or row_active.shape != (n_pad,):
            raise ValueError(f"cells must be ({n_pad}, 3), row_active "
                             f"({n_pad},)")
        cells = cells.to(torch.int32).contiguous()
        row_active = row_active.to(torch.bool).contiguous()
        lane_rows = lane_stride if lane_rows is None else lane_rows
        if not 0 < lane_rows <= lane_stride:
            raise ValueError(f"lane_rows={lane_rows} must be in (0, "
                             f"{lane_stride}]")
    else:
        position, diameter, agent_type, alive, active = pool
        n_rows = position.shape[0]
        lane_rows = n_rows // lanes
        if lane_rows * lanes != n_rows or lane_rows > lane_stride \
                or position.shape != (n_rows, 3) or any(
                    x.shape != (n_rows,) for x in pool[1:]):
            raise ValueError(f"pool channels must have {n_rows} rows, "
                             f"{lanes} lanes of at most {lane_stride}")
        if origin is None or origin.shape != (3,) or box_size is None:
            raise ValueError("a pool needs origin (3,) and box_size")
        position = position.to(torch.float32).contiguous()
        diameter = diameter.to(torch.float32).contiguous()
        agent_type = agent_type.to(torch.int32).contiguous()
        alive = alive.to(torch.bool).contiguous()
        active = active.to(torch.bool).contiguous()
        origin = origin.to(torch.float32).contiguous()
        recip = float(np.float32(1.0) / np.float32(box_size))  # cell_of's
        data_t = torch.empty((8, n_pad), dtype=torch.float32, device=dev)
        mask = torch.empty((n_pad,), dtype=torch.bool, device=dev)
    for name, x in (("cells", cells), ("row_active", row_active),
                    ("position", position), ("diameter", diameter),
                    ("agent_type", agent_type), ("alive", alive),
                    ("active", active), ("origin", origin),
                    ("counts", counts)):
        if x is not None and x.device != dev:
            raise ValueError(f"{name} is on {x.device}, starts on {dev}")
    cols = torch.empty((n_pad // BLOCK, maxb), dtype=torch.int32, device=dev)
    ovf = torch.zeros(() if lanes == 1 else (lanes,), dtype=torch.int32,
                      device=dev)
    fn = _kernel_fn()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(_ptr(cells), _ptr(row_active), _ptr(position),
                 _ptr(diameter), _ptr(agent_type), _ptr(alive), _ptr(active),
                 n_rows, _ptr(origin), recip, starts.data_ptr(),
                 counts.data_ptr(), n_pad, dims[0], dims[1], dims[2], maxb,
                 span, lane_rows, lane_stride, cols.data_ptr(),
                 ovf.data_ptr(), _ptr(data_t), _ptr(mask), stream)
    if err != 0:
        raise RuntimeError(f"K1 column-map launch failed: CUDA error {err}")
    column_map.launches += 1
    return cols, ovf != 0, data_t, mask


column_map.launches = 0
