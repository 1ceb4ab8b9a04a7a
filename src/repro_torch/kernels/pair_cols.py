"""K1's column map from a Verlet pair list on the card: the CUDA kernel's
wrapper.

``csrc/pair_cols.cu`` builds the map that
``ops.build_block_cols_from_pairs`` defines (its header says how), and in
the same launch can do the rest of ``ops.k1_inputs``: the row mask and the
pack of K1's data rows. :func:`column_map_from_pairs` is the one function
that launches it (counted in ``column_map_from_pairs.launches``); the
plain versions are ``ops.build_block_cols_from_pairs_plain`` and
``ops.k1_inputs_plain``, which ``ops`` runs for CPU tensors. There is no
other path: a failed build or launch raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import build

BLOCK = 128

# k1_pair_cols(idx, run_off, max_pairs, row_active, position, diameter,
#              agent_type, alive, active, n_rows, n_pad, maxb, lane_rows,
#              lane_stride, block_cols, overflow, data_t, row_mask, stream)
ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p]

Pool = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
             torch.Tensor]


_FNS: dict = {}


def _kernel_fn():
    """The built library's ``k1_pair_cols``, bound once."""
    if not _FNS:
        fn = build.load("pair_cols").k1_pair_cols
        fn.argtypes = ARGTYPES
        fn.restype = ctypes.c_int
        _FNS["map"] = fn
    return _FNS["map"]


def _ptr(x: Optional[torch.Tensor]) -> int:
    return 0 if x is None else x.data_ptr()


def launch_args(idx: torch.Tensor, run_off: torch.Tensor, n_pad: int,
                maxb: int, *, row_active: Optional[torch.Tensor] = None,
                pool: Optional[Pool] = None, lanes: int = 1
                ) -> Tuple[list, Tuple]:
    """:func:`column_map_from_pairs`' checks and outputs: ``(the C entry
    point's arguments but the stream, (block_cols, overflow, data_t,
    mask, then the inputs as converted, which must outlive the
    launch))``. Raises ``ValueError`` on what the kernel does not take."""
    dev = idx.device
    if dev.type != "cuda":
        raise ValueError(f"the pairs column-map kernel runs on CUDA "
                         f"tensors, not {dev}")
    if (row_active is None) == (pool is None):
        raise ValueError("give either row_active or a pool")
    c = idx.shape[0]
    if idx.dim() != 2 or run_off.shape != (c, 10):
        raise ValueError(f"idx must be (C, P) and run_off (C, 10), got "
                         f"{tuple(idx.shape)}, {tuple(run_off.shape)}")
    if n_pad % BLOCK or c > n_pad or 8 * n_pad >= 2 ** 31 or maxb < 0:
        raise ValueError(f"n_pad={n_pad} must be a multiple of {BLOCK}, at "
                         f"least C={c} and below 2^28; maxb={maxb}")
    if lanes < 1 or c % lanes or n_pad % lanes \
            or (n_pad // lanes) % BLOCK or c // lanes > n_pad // lanes:
        raise ValueError(f"{c} rows in {n_pad} packed rows do not split "
                         f"into {lanes} lanes of whole row blocks")
    if c * idx.shape[1] >= 2 ** 31:
        raise ValueError(f"{c} rows x {idx.shape[1]} entries do not fit "
                         f"int32")
    idx = idx.to(torch.int32).contiguous()
    run_off = run_off.to(torch.int32).contiguous()
    data_t = mask = position = diameter = agent_type = alive = active = None
    if row_active is not None:
        if row_active.shape != (n_pad,):
            raise ValueError(f"row_active must be ({n_pad},)")
        row_active = row_active.to(torch.bool).contiguous()
    else:
        position, diameter, agent_type, alive, active = pool
        if position.shape != (c, 3) or any(x.shape != (c,)
                                           for x in pool[1:]):
            raise ValueError(f"pool channels must have the list's {c} rows")
        position = position.to(torch.float32).contiguous()
        diameter = diameter.to(torch.float32).contiguous()
        agent_type = agent_type.to(torch.int32).contiguous()
        alive = alive.to(torch.bool).contiguous()
        active = active.to(torch.bool).contiguous()
        data_t = torch.empty((8, n_pad), dtype=torch.float32, device=dev)
        mask = torch.empty((n_pad,), dtype=torch.bool, device=dev)
    for name, x in (("run_off", run_off), ("row_active", row_active),
                    ("position", position), ("diameter", diameter),
                    ("agent_type", agent_type), ("alive", alive),
                    ("active", active)):
        if x is not None and x.device != dev:
            raise ValueError(f"{name} is on {x.device}, idx on {dev}")
    cols = torch.empty((n_pad // BLOCK, maxb), dtype=torch.int32, device=dev)
    ovf = torch.zeros(() if lanes == 1 else (lanes,), dtype=torch.int32,
                      device=dev)
    args = [idx.data_ptr(), run_off.data_ptr(), idx.shape[1],
            _ptr(row_active), _ptr(position), _ptr(diameter),
            _ptr(agent_type), _ptr(alive), _ptr(active), c, n_pad, maxb,
            c // lanes, n_pad // lanes, cols.data_ptr(), ovf.data_ptr(),
            _ptr(data_t), _ptr(mask)]
    return args, (cols, ovf, data_t, mask, idx, run_off, row_active,
                  position, diameter, agent_type, alive, active)


def column_map_from_pairs(idx: torch.Tensor, run_off: torch.Tensor,
                          n_pad: int, maxb: int, *,
                          row_active: Optional[torch.Tensor] = None,
                          pool: Optional[Pool] = None, lanes: int = 1):
    """The column map of ``n_pad`` rows from a pair list (``idx`` (C, P)
    int32, ``run_off`` (C, 10) int32) on the card, with the rows' activity
    from ``row_active`` (n_pad,) bool or from ``pool`` = (position (C, 3)
    f32, diameter (C,) f32, agent_type (C,) int, alive (C,) bool, active
    (C,) bool).

    Returns ``(block_cols (n_pad/128, maxb) int32, overflow () bool, data_t
    (8, n_pad) f32 or None, row mask (n_pad,) bool or None)`` — the last
    two only from a pool.

    ``lanes`` > 1: an ensemble's list, its C rows ``lanes`` lanes of C /
    lanes (lane-major, entries slot ids of the whole pool), packed at
    n_pad / lanes rows each (``ops.lane_stride``); each row block maps its
    own lane, and the overflow is (lanes,).
    """
    args, held = launch_args(idx, run_off, n_pad, maxb,
                             row_active=row_active, pool=pool, lanes=lanes)
    dev = held[0].device
    fn = _kernel_fn()
    with torch.cuda.device(dev):
        err = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"pairs column-map launch failed: CUDA error "
                           f"{err}")
    column_map_from_pairs.launches += 1
    cols, ovf, data_t, mask = held[:4]
    return cols, ovf != 0, data_t, mask


column_map_from_pairs.launches = 0
