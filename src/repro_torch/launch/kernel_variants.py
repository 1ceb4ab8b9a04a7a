"""The first designs of the pair-list, pairs column-map, secretion and K2
kernels, built on the card to time them beside the kernels that replaced
them. Nothing on any path of the port calls this module; ``chip_smoke.py``
phases 5, 12, 13, 15, 26, 28 and the K2 checks of 31, 32 and 38 time each
beside its successor on the same inputs:

* ``variants/pairlist_warp_row.cu``: a warp a row, the 9 runs walked one
  after another in 32-lane passes, one ``atomicMax`` a row;
* ``variants/pair_cols_row_walk.cu``: a warp walks its 32 rows one at a
  time, reading each row's stored entries from device memory twice (a
  bounds pass, a bitmap pass), a whole 1,024-word window cleared and
  counted;
* ``variants/secretion_sorted.cu``: the voxel ids computed by torch ops
  (``voxel_of``, ``_flat``), a stable ``torch.sort`` of the int64 ids, a
  clone of the grid, then a thread a voxel folds its sorted segment;
* ``variants/flash_attention_first.cu``: K2's tensor-core kernel at D 64,
  96 (the D 128 kernel on zero columns) and 128, and its scalar kernel in
  f32 at D 96 and 128 (scalar 32-bit shared loads, three block barriers a
  tile), as they were before their redesign. At D 64 and 128 the
  tensor-core kernel is the same code in both libraries, so its output
  must be the same bits.

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
from ..kernels import flash_attention as k2

_DIR = Path(__file__).resolve().parent / "variants"
FIRST = {"pairlist_warp_row": "pairlist_build",
         "pair_cols_row_walk": "k1_pair_cols",
         "secretion_sorted": "secretion_add",
         "flash_attention_first": "k2_flash_attention"}
_FNS: dict = {}

# secretion_add(keys, perm, amount, n, conc, stream)
SECRETION_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                      ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p]
ARGTYPES = {"pairlist_warp_row": pairlist.ARGTYPES,
            "pair_cols_row_walk": pair_cols.ARGTYPES,
            "secretion_sorted": SECRETION_ARGTYPES,
            "flash_attention_first": k2.ARGTYPES}


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


def flash_attention_first(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          scale: Optional[float] = None,
                          sk_actual: Optional[int] = None,
                          kv_offset: Optional[int] = None) -> torch.Tensor:
    """``kernels/flash_attention.flash_attention`` on the card by K2's first
    designs (bf16 at D 64, 96, 128; f32 at D 96, 128), with the wrapper's
    defaults, checks and argument layout."""
    scale, sk_actual, kv_offset = k2._resolve(q, k, scale, sk_actual,
                                              kv_offset)
    k2._check(q, k, v, sk_actual)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    args, _keep = k2._launch_args(q, k, v, out, causal, scale, sk_actual,
                                  kv_offset)
    err = _functions()["flash_attention_first"](
        *args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"K2 first design: error {err}")
    return out
