"""Secretion into the diffusion grid on the card, in slot order: the CUDA
kernel's wrapper.

``csrc/secretion.cu`` adds each voxel's amounts in slot order, as the
reference's scatter does on XLA:CPU (its header says how). The plain
version is ``index_add`` on the CPU, which adds in the same order;
``core/diffusion.add_sources`` runs it for CPU tensors and :func:`add` for
CUDA tensors. :func:`add` is the one function that launches the kernel
(counted in ``add.launches``). There is no other path: a failed build or
launch raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

# secretion_add(keys, perm, amount, n, conc, stream)
ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p]


def _kernel_fn():
    lib = build.load("secretion")
    fn = lib.secretion_add
    fn.argtypes = ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def add(conc: torch.Tensor, flat: torch.Tensor, amount: torch.Tensor
        ) -> torch.Tensor:
    """``conc`` (any shape, f32) with ``amount[i]`` (N,) added at the flat
    voxel ``flat[i]`` (N,) int64, each voxel's amounts in slot order, on
    the card. Returns a new tensor."""
    dev = conc.device
    if dev.type != "cuda":
        raise ValueError(f"the secretion kernel runs on CUDA tensors, not "
                         f"{dev}")
    n = flat.shape[0]
    if conc.dtype != torch.float32 or flat.shape != (n,) \
            or amount.shape != (n,):
        raise ValueError(f"conc must be float32 and flat, amount (N,), got "
                         f"{conc.dtype}, {tuple(flat.shape)}, "
                         f"{tuple(amount.shape)}")
    for name, x in (("flat", flat), ("amount", amount)):
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, conc on {dev}")
    out = conc.contiguous().clone()
    keys, perm = torch.sort(flat.to(torch.int64), stable=True)
    amount = amount.to(torch.float32).contiguous()
    fn = _kernel_fn()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(keys.data_ptr(), perm.data_ptr(), amount.data_ptr(), n,
                 out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"secretion launch failed: CUDA error {err}")
    add.launches += 1
    return out


add.launches = 0
