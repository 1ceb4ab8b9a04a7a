"""Secretion into the diffusion grid on the card, in slot order: the CUDA
kernel's wrapper.

``csrc/secretion.cu`` computes each row's voxel itself (``voxel_of`` and
``_flat`` of ``core/diffusion.py``, lanes included) and adds each voxel's
amounts in slot order, as the reference's scatter does on XLA:CPU (its
header says how). The plain version is ``index_add`` on the CPU, which
adds in the same order; ``core/diffusion.add_sources`` runs it for CPU
tensors and :func:`add` for CUDA tensors. :func:`add` is the one function
that launches the kernel (counted in ``add.launches``, once a call). There
is no other path: a failed build or launch raises.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import build

# secretion_add(position, amount, n_rows, origin, recip, dim_x, dim_y,
#               dim_z, lane_rows, conc, total_voxels, out, scratch,
#               scratch_bytes, stream)
ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]

_FNS: dict = {}


def _kernel_fns():
    """(secretion_add, secretion_scratch_bytes) of the built library,
    bound once."""
    if not _FNS:
        lib = build.load("secretion")
        lib.secretion_add.argtypes = ARGTYPES
        lib.secretion_add.restype = ctypes.c_int
        lib.secretion_scratch_bytes.argtypes = [ctypes.c_int] * 3
        lib.secretion_scratch_bytes.restype = ctypes.c_longlong
        _FNS["add"] = lib.secretion_add
        _FNS["scratch"] = lib.secretion_scratch_bytes
    return _FNS["add"], _FNS["scratch"]


def add(conc: torch.Tensor, position: torch.Tensor, amount: torch.Tensor,
        origin: torch.Tensor, dims: Tuple[int, int, int], recip: float,
        lane_rows: int) -> torch.Tensor:
    """``conc`` (a (X, Y, Z) grid, or L lanes' (L, X, Y, Z), f32) with
    ``amount[i]`` (N,) added at the voxel of ``position[i]`` (N, 3): the
    voxel is ``floor((p − origin) · recip)`` clamped into ``dims``, in the
    grid of lane ``i // lane_rows``; each voxel's amounts in slot order, on
    the card. ``recip`` is float32(1 / voxel). Returns a new tensor."""
    n = position.shape[0]
    voxels = dims[0] * dims[1] * dims[2]
    if conc.dtype != torch.float32 or position.shape != (n, 3) \
            or amount.shape != (n,) or origin.shape != (3,):
        raise ValueError(f"conc must be float32, position (N, 3), amount "
                         f"(N,) and origin (3,), got {conc.dtype}, "
                         f"{tuple(position.shape)}, {tuple(amount.shape)}, "
                         f"{tuple(origin.shape)}")
    if min(dims) < 1 or 3 * n >= 2 ** 31 or conc.numel() >= 2 ** 31:
        raise ValueError(f"grid {dims} with {n} rows and {conc.numel()} "
                         f"voxels does not fit int32 indices")
    if n and (lane_rows < 1 or n % lane_rows):
        raise ValueError(f"{n} rows do not split into lanes of {lane_rows}")
    lanes = n // lane_rows if n else max(conc.numel() // voxels, 1)
    if conc.numel() != lanes * voxels:
        raise ValueError(f"{n} rows in lanes of {lane_rows} do not match a "
                         f"grid of {tuple(conc.shape)} over dims {dims}")
    dev = conc.device
    if dev.type != "cuda":
        raise ValueError(f"the secretion kernel runs on CUDA tensors, not "
                         f"{dev}")
    for name, x in (("position", position), ("amount", amount),
                    ("origin", origin)):
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, conc on {dev}")
    conc = conc.contiguous()
    position = position.to(torch.float32).contiguous()
    amount = amount.to(torch.float32).contiguous()
    origin = origin.to(torch.float32).contiguous()
    out = torch.empty_like(conc)
    fn, scratch_fn = _kernel_fns()
    # the radix path's buffers; none on the one-launch local path
    size = scratch_fn(n, lane_rows, conc.numel())
    scratch = (torch.empty((size,), dtype=torch.uint8, device=dev)
               if size else None)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(position.data_ptr(), amount.data_ptr(), n,
                 origin.data_ptr(), recip, dims[0], dims[1], dims[2],
                 lane_rows, conc.data_ptr(), conc.numel(), out.data_ptr(),
                 scratch.data_ptr() if size else None, size, stream)
    if err != 0:
        raise RuntimeError(f"secretion launch failed: CUDA error {err}")
    add.launches += 1
    return out


add.launches = 0
