"""The Verlet pair-list build on the card: the CUDA kernel's wrapper.

``csrc/pairlist.cu`` builds the list that ``core/grid.py::build_pairlist``
defines (its header says how); the plain version is
``grid.build_pairlist_plain``, which ``grid.build_pairlist`` runs for CPU
tensors. :func:`build_list` is the one function that launches the kernel
(counted in ``build_list.launches``). There is no other path: a failed
build or launch raises.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from . import build

# FP32 operations per candidate lane in csrc/pairlist.cu, each counted
# once: dx, dy, dz, three products, two sums and the compare. The work
# unit of the bound chip_smoke.py reports.
OPS_PER_LANE = 9

# pairlist_build(position, alive, n_rows, origin, recip, starts, counts,
#                dim_x, dim_y, dim_z, run_cap, r2, max_pairs, lane_rows, idx,
#                run_off, count, demand, stream)
ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]


_FNS: dict = {}


def _kernel_fn():
    """The built library's ``pairlist_build``, bound once."""
    if not _FNS:
        fn = build.load("pairlist").pairlist_build
        fn.argtypes = ARGTYPES
        fn.restype = ctypes.c_int
        _FNS["build"] = fn
    return _FNS["build"]


def launch_args(position: torch.Tensor, alive: torch.Tensor,
                origin: torch.Tensor, box_size: float, starts: torch.Tensor,
                counts: torch.Tensor, dims: Tuple[int, int, int],
                run_capacity: int, r2: float, max_pairs: int,
                lanes: int = 1) -> Tuple[list, Tuple[torch.Tensor, ...]]:
    """:func:`build_list`'s checks and outputs: ``(the C entry point's
    arguments but the stream, (idx, run_off, count, demand, then the
    inputs as converted, which must outlive the launch))``. Raises
    ``ValueError`` on what the kernel does not take."""
    c = position.shape[0]
    m = dims[0] * dims[1] * dims[2]
    if position.shape != (c, 3) or alive.shape != (c,) or 3 * c >= 2 ** 31:
        raise ValueError(f"position must be (C, 3) and alive (C,) with "
                         f"3·C < 2^31, got {tuple(position.shape)}, "
                         f"{tuple(alive.shape)}")
    if lanes < 1 or c % lanes:
        raise ValueError(f"{c} rows do not split into {lanes} lanes")
    if lanes * m >= 2 ** 31 or min(dims) < 1:
        raise ValueError(f"{lanes} lanes of grid {dims} do not fit int32 "
                         f"box ids")
    if max_pairs >= 1 and c * max_pairs >= 2 ** 31:
        raise ValueError(f"{c} rows x max_pairs {max_pairs} do not fit "
                         f"int32 entries")
    if starts.shape != (lanes * m,) or counts.shape != (lanes * m,) \
            or origin.shape != (3,):
        raise ValueError(f"starts/counts must be ({lanes * m},) and origin "
                         f"(3,)")
    if max_pairs < 1 or run_capacity < 0:
        raise ValueError(f"max_pairs={max_pairs}, "
                         f"run_capacity={run_capacity}")
    dev = position.device
    if dev.type != "cuda":
        raise ValueError(f"the pair-list kernel runs on CUDA tensors, not "
                         f"{dev}")
    for name, x in (("alive", alive), ("origin", origin), ("starts", starts),
                    ("counts", counts)):
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, position on {dev}")
    position = position.to(torch.float32).contiguous()
    alive = alive.to(torch.bool).contiguous()
    origin = origin.to(torch.float32).contiguous()
    starts = starts.to(torch.int32).contiguous()
    counts = counts.to(torch.int32).contiguous()
    recip = float(np.float32(1.0) / np.float32(box_size))  # cell_of's
    idx = torch.empty((c, max_pairs), dtype=torch.int32, device=dev)
    run_off = torch.empty((c, 10), dtype=torch.int32, device=dev)
    count = torch.empty((c,), dtype=torch.int32, device=dev)
    demand = torch.zeros(() if lanes == 1 else (lanes,), dtype=torch.int32,
                         device=dev)
    args = [position.data_ptr(), alive.data_ptr(), c, origin.data_ptr(),
            recip, starts.data_ptr(), counts.data_ptr(), dims[0], dims[1],
            dims[2], run_capacity, r2, max_pairs, c // lanes, idx.data_ptr(),
            run_off.data_ptr(), count.data_ptr(), demand.data_ptr()]
    return args, (idx, run_off, count, demand, position, alive, origin,
                  starts, counts)


def build_list(position: torch.Tensor, alive: torch.Tensor,
               origin: torch.Tensor, box_size: float, starts: torch.Tensor,
               counts: torch.Tensor, dims: Tuple[int, int, int],
               run_capacity: int, r2: float, max_pairs: int,
               lanes: int = 1
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                          torch.Tensor]:
    """The pair list of the resident pool ``position`` (C, 3) f32 /
    ``alive`` (C,) bool over the grid's ``starts``/``counts`` (M,) tables,
    on the card. ``r2`` is the inclusive squared radius as a float32 value.

    Returns ``(idx (C, max_pairs) int32, run_off (C, 10) int32, count (C,)
    int32, demand () int32)``.

    ``lanes`` > 1: an ensemble's lane-major pool of ``lanes`` lanes of C /
    lanes rows and its (lanes·M,) tables; each row lists its own lane's
    candidates, and ``demand`` is (lanes,).
    """
    args, held = launch_args(position, alive, origin, box_size, starts,
                             counts, dims, run_capacity, r2, max_pairs,
                             lanes)
    dev = held[0].device
    fn = _kernel_fn()
    with torch.cuda.device(dev):
        err = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"pair-list launch failed: CUDA error {err}")
    build_list.launches += 1
    return held[:4]


build_list.launches = 0
