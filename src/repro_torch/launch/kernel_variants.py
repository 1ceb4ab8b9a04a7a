"""The first designs of the pair-list, pairs column-map and secretion
kernels, built on the card to time them beside the kernels that replaced
them. Nothing on any path of the port calls this module; ``chip_smoke.py``
phases 12, 13, 15, 26 and 28 time each beside its successor on the same
inputs:

* ``variants/pairlist_warp_row.cu``: a warp a row, the 9 runs walked one
  after another in 32-lane passes, one ``atomicMax`` a row;
* ``variants/pair_cols_row_walk.cu``: a warp walks its 32 rows one at a
  time, reading each row's stored entries from device memory twice (a
  bounds pass, a bitmap pass), a whole 1,024-word window cleared and
  counted;
* ``variants/secretion_sorted.cu``: the voxel ids computed by torch ops
  (``voxel_of``, ``_flat``), a stable ``torch.sort`` of the int64 ids, a
  clone of the grid, then a thread a voxel folds its sorted segment.

Each takes the same inputs as the committed kernel's wrapper and returns
the same outputs. They build at once on the first call, through
``kernels/build.py``'s loader, so a built library is reused. Runs on the
CUDA card only.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Tuple

import torch

from ..core import diffusion
from ..core.lanes import Lanes
from ..kernels import build, pair_cols, pairlist

_DIR = Path(__file__).resolve().parent / "variants"
FIRST = {"pairlist_warp_row": "pairlist_build",
         "pair_cols_row_walk": "k1_pair_cols",
         "secretion_sorted": "secretion_add"}
_FNS: dict = {}

# secretion_add(keys, perm, amount, n, conc, stream)
SECRETION_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                      ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p]
ARGTYPES = {"pairlist_warp_row": pairlist.ARGTYPES,
            "pair_cols_row_walk": pair_cols.ARGTYPES,
            "secretion_sorted": SECRETION_ARGTYPES}


def _functions():
    """{first design: its C entry point}, built on the first call."""
    if not _FNS:
        build.build_all(list(FIRST), _DIR)
        for name, entry in FIRST.items():
            fn = getattr(build.load(name, _DIR), entry)
            fn.argtypes = ARGTYPES[name]
            fn.restype = ctypes.c_int
            _FNS[name] = fn
    return _FNS


def pairlist_build(position, alive, origin, box_size: float, starts, counts,
                   dims: Tuple[int, int, int], run_capacity: int, r2: float,
                   max_pairs: int, lanes: int = 1):
    """``kernels/pairlist.build_list`` by the warp-a-row kernel."""
    args, held = pairlist.launch_args(position, alive, origin, box_size,
                                      starts, counts, dims, run_capacity,
                                      r2, max_pairs, lanes)
    fn = _functions()["pairlist_warp_row"]
    err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"warp-a-row pair list: CUDA error {err}")
    return held[:4]


def pair_cols_map(idx: torch.Tensor, run_off: torch.Tensor, n_pad: int,
                  maxb: int, *, row_active: Optional[torch.Tensor] = None,
                  pool=None, lanes: int = 1):
    """``kernels/pair_cols.column_map_from_pairs`` by the row-walk
    kernel."""
    args, held = pair_cols.launch_args(idx, run_off, n_pad, maxb,
                                       row_active=row_active, pool=pool,
                                       lanes=lanes)
    err = _functions()["pair_cols_row_walk"](
        *args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"row-walk pairs column map: CUDA error {err}")
    cols, ovf, data_t, mask = held[:4]
    return cols, ovf != 0, data_t, mask


def secretion_add(spec: diffusion.DiffusionSpec, conc: torch.Tensor,
                  position: torch.Tensor, amount: torch.Tensor,
                  origin: torch.Tensor, lanes: Optional[Lanes] = None
                  ) -> torch.Tensor:
    """``core/diffusion.add_sources`` on the card by the sort-then-fold
    design: the voxel ids by torch ops, a stable sort, the fold."""
    flat = diffusion._flat(spec, diffusion.voxel_of(spec, position, origin),
                           lanes)
    out = conc.contiguous().clone()
    keys, perm = torch.sort(flat, stable=True)
    amount = amount.to(torch.float32).contiguous()
    fn = _functions()["secretion_sorted"]
    err = fn(keys.data_ptr(), perm.data_ptr(), amount.data_ptr(),
             keys.shape[0], out.data_ptr(),
             torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"sort-then-fold secretion: CUDA error {err}")
    return out
