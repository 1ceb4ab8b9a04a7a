"""The first designs of the pair-list and secretion kernels, built on the
card to time them beside the kernels that replaced them. Nothing on any
path of the port calls this module; ``chip_smoke.py`` phases 12, 15 and 26
time each beside its successor on the same inputs:

* ``variants/pairlist_warp_row.cu``: a warp a row, the 9 runs walked one
  after another in 32-lane passes, one ``atomicMax`` a row;
* ``variants/secretion_sorted.cu``: the voxel ids computed by torch ops
  (``voxel_of``, ``_flat``), a stable ``torch.sort`` of the int64 ids, a
  clone of the grid, then a thread a voxel folds its sorted segment.

Each takes the same inputs as the committed kernel's wrapper and returns
the same outputs. Both build at once on the first call, through
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
from ..kernels import build, pairlist

_DIR = Path(__file__).resolve().parent / "variants"
FIRST = {"pairlist_warp_row": "pairlist_build",
         "secretion_sorted": "secretion_add"}
_FNS: dict = {}

# secretion_add(keys, perm, amount, n, conc, stream)
SECRETION_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                      ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p]


def _functions():
    """{first design: its C entry point}, built on the first call."""
    if not _FNS:
        build.build_all(list(FIRST), _DIR)
        for name, entry in FIRST.items():
            fn = getattr(build.load(name, _DIR), entry)
            fn.argtypes = (pairlist.ARGTYPES if name == "pairlist_warp_row"
                           else SECRETION_ARGTYPES)
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
