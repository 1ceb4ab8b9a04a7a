"""K2: flash attention — the CUDA kernel's wrapper and its plain PyTorch
version.

Replaces ``repro/kernels/flash_attention.py::flash_attention_kernel`` (the
Pallas TPU kernel). The kernels are in ``csrc/flash_attention.cu``; its
header says how the TPU design was translated and what bounds it. The
choice between them is static (:func:`kernel_path`): bf16 with D 64, 96 or
128 runs on the tensor cores (wgmma, TMA), everything else on the scalar
kernel.

:func:`flash_attention` takes q (B, Hq, Sq, D) and k, v (B, Hkv, Sk, D),
``Hq % Hkv == 0``, all float32 or all bfloat16, D in {16, 32, 64, 96, 128}
(other head dims raise ``ValueError``; the reference's K2 takes any), and
returns softmax(q·kᵀ·scale)·v (B, Hq, Sq, D) in q's dtype, accumulated in
float32. Keys at or past ``sk_actual`` are masked; when ``causal``, key
``j`` is visible to query ``i`` iff ``j <= i + kv_offset`` (queries aligned
to the end of the keys). Masked scores are -1e30 with p forced to 0, and a
row with no visible key is 0. q, k and v may be strided views: the
tensor-core kernel reads any (B, H, S) strides that are multiples of 8 with
unit stride along D and a 16-byte-aligned base (a transposed V needs no
copy); other layouts, and every input of the scalar kernel, are made
contiguous first. On a CUDA tensor it launches the kernel (and counts the
launch in ``flash_attention.launches``); on a CPU tensor it runs
:func:`flash_attention_plain`. There is no other path: a failed build,
tensor-map encode or launch raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from . import build

SUPPORTED_D = (16, 32, 64, 96, 128)
TENSOR_CORE_D = (64, 96, 128)       # bf16 head dims of the wgmma kernel
NEG_INF = -1e30
# operations per visible (query, key) pair, per unit of D: q·k and p·v,
# a multiply and an add each — the work unit of the bound chip_smoke.py
# reports
OPS_PER_PAIR_PER_D = 4
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# the plain version materialises (B, Hq, rows, Sk) scores; rows per chunk
# keep that under ~2^28 elements
_PLAIN_ELEMS = 1 << 28
# the C entry point returns 10000 + CUresult when a tensor-map encode fails
_ENCODE_ERROR = 10000


def _resolve(q: torch.Tensor, k: torch.Tensor, scale: Optional[float],
             sk_actual: Optional[int], kv_offset: Optional[int]
             ) -> tuple[float, int, int]:
    """Defaults of the TPU kernel: scale 1/√D, sk_actual Sk,
    kv_offset sk_actual − Sq."""
    d = q.shape[-1]
    scale = 1.0 / (d ** 0.5) if scale is None else float(scale)
    sk_actual = k.shape[2] if sk_actual is None else int(sk_actual)
    kv_offset = sk_actual - q.shape[2] if kv_offset is None else int(kv_offset)
    return scale, sk_actual, kv_offset


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           sk_actual: int) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"q must be (B, Hq, Sq, D) and k, v (B, Hkv, Sk, D),"
                         f" got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, hq, _, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or k.shape[1] == 0 \
            or hq % k.shape[1]:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)} (batch, D, Hq % Hkv == 0)")
    if d not in SUPPORTED_D:
        raise ValueError(f"head dim {d} not in {SUPPORTED_D}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must all be float32 or all bfloat16, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not 0 <= sk_actual <= k.shape[2]:
        raise ValueError(f"sk_actual={sk_actual} outside [0, {k.shape[2]}]")
    for name, x in (("k", k), ("v", v)):
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")


def kernel_path(dtype: torch.dtype, d: int) -> str:
    """The CUDA kernel K2 runs for this input type and head dim, a static
    choice (no fallback):

    * ``"tensor_core"``: bf16 at D 64, 96 or 128. Bound by the bf16 tensor
      cores: wgmma fed by TMA loads through a 3-stage K/V ring, one
      producer and two consumer warpgroups, each consumer overlapping a
      tile's softmax with the previous tile's P·V, P split into bf16 hi +
      lo (the port's bf16 check needs it). D 96 holds its tiles as three
      32-column sub-tiles in 64-byte swizzle and runs P·V at n96, so no
      column past 96 is loaded or multiplied.
    * ``"scalar"``: every f32 input (TF32 would miss the 2e-5 gate), and
      bf16 at D 16 or 32. Bound by the FP32 FMA units if shared memory
      keeps up: 4-row × 4-key and 4-row × D/8-column register blocks read
      by 128-bit shared loads (8-13 FMAs a wavefront), K and V loaded by
      cp.async under the other operand's product, the softmax in
      registers, heavy query tiles first."""
    if dtype == torch.bfloat16 and d in TENSOR_CORE_D:
        return "tensor_core"
    return "scalar"


def _strides(x: torch.Tensor) -> tuple[int, int, int]:
    """(B, H, S) strides of a (B, H, S, D) view in elements; a dimension of
    size 1 takes its contiguous stride (its own is arbitrary in PyTorch and
    a tensor map needs a multiple of 16 bytes)."""
    b, h, s, d = x.shape
    sb, sh, ss, _ = x.stride()
    return (h * s * d if b == 1 else sb, s * d if h == 1 else sh,
            d if s == 1 else ss)


def kernel_takes(x: torch.Tensor, path: str) -> bool:
    """Whether the kernel of ``path`` reads ``x`` as it lies: the
    tensor-core kernel takes unit stride along D, (B, H, S) strides that
    are multiples of 8 elements (16 bytes) and a 16-byte-aligned base; the
    scalar kernel takes contiguous tensors only."""
    if path == "scalar":
        return x.is_contiguous()
    sb, sh, ss = _strides(x)
    return x.stride(-1) == 1 and not (sb % 8 or sh % 8 or ss % 8) \
        and x.data_ptr() % 16 == 0


def _launch_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 out: torch.Tensor, causal: bool, scale: float,
                 sk_actual: int, kv_offset: int) -> tuple:
    """``(arguments of the C entry point before the stream, (q, k, v) as
    passed)``: each of q, k and v is copied into a fresh contiguous tensor
    only where the kernel cannot read it as it lies, and passed with its
    (B, H, S) strides; the output is contiguous."""
    path = kernel_path(q.dtype, q.shape[-1])
    q, k, v = (x if kernel_takes(x, path)
               else x.clone(memory_format=torch.contiguous_format)
               for x in (q, k, v))
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    return (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPE_CODE[q.dtype], b, hq, hkv, sq, sk, d, sk_actual,
            kv_offset, int(causal), scale, *_strides(q), *_strides(k),
            *_strides(v)), (q, k, v)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: Optional[float] = None,
                    sk_actual: Optional[int] = None,
                    kv_offset: Optional[int] = None) -> torch.Tensor:
    """K2 on q's device: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors. ``scale`` defaults to 1/√D, ``sk_actual`` to Sk and
    ``kv_offset`` to sk_actual − Sq, as in the TPU kernel.

    K2 has no backward (nor has the TPU kernel): under autograd, with q, k
    or v requiring grad, it raises on every device rather than return an
    output cut from the graph. Training runs the plain ``_sdpa``."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("K2 flash_attention has no backward: call it "
                           "under torch.no_grad(), or train with "
                           "attn_impl='sdpa'")
    scale, sk_actual, kv_offset = _resolve(q, k, scale, sk_actual, kv_offset)
    _check(q, k, v, sk_actual)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, scale=scale,
                                     sk_actual=sk_actual, kv_offset=kv_offset)
    if q.device.type != "cuda":
        raise ValueError(f"K2 runs on CUDA or CPU tensors, not {q.device}")
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    args, _keep = _launch_args(q, k, v, out, causal, scale, sk_actual,
                               kv_offset)
    fn = _lib().k2_flash_attention
    with torch.cuda.device(q.device):
        err = fn(*args, torch.cuda.current_stream(q.device).cuda_stream)
    if err >= _ENCODE_ERROR:
        raise RuntimeError(f"K2 flash_attention: cuTensorMapEncodeTiled "
                           f"failed with CUresult {err - _ENCODE_ERROR}")
    if err != 0:
        raise RuntimeError(f"K2 flash_attention launch failed: CUDA error "
                           f"{err}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


# k2_flash_attention(q, k, v, o, dtype, b, hq, hkv, sq, sk, d, sk_actual,
#                    kv_offset, causal, scale, q_sb, q_sh, q_ss, k_sb, k_sh,
#                    k_ss, v_sb, v_sh, v_ss, stream)
ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 10 + [ctypes.c_float]
            + [ctypes.c_longlong] * 9 + [ctypes.c_void_p])


@functools.cache
def _lib():
    lib = build.load("flash_attention")
    lib.k2_flash_attention.argtypes = ARGTYPES
    lib.k2_flash_attention.restype = ctypes.c_int
    lib.k2_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.k2_smem_bytes.restype = ctypes.c_int
    return lib


def smem_bytes(dtype: torch.dtype, d: int) -> int:
    """Dynamic shared memory of one K2 block for this type and head dim
    (from the built library)."""
    return int(_lib().k2_smem_bytes(_DTYPE_CODE[dtype], d))


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          scale: Optional[float] = None,
                          sk_actual: Optional[int] = None,
                          kv_offset: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch K2 on any device: the kernel's result computed directly
    (one softmax over all keys, not tile by tile), with its masks, its −1e30
    fill and its ``l = 0 → 0`` rule. Query rows go in chunks so the score
    block stays bounded."""
    scale, sk_actual, kv_offset = _resolve(q, k, scale, sk_actual, kv_offset)
    _check(q, k, v, sk_actual)
    b, hq, sq, _ = q.shape
    group = hq // k.shape[1]
    sk = k.shape[2]
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    kpos = torch.arange(sk, device=q.device)
    out = torch.empty_like(q)
    rows = max(1, _PLAIN_ELEMS // max(1, b * hq * sk))
    for r0 in range(0, sq, rows):
        r1 = min(sq, r0 + rows)
        s = torch.einsum("bhqd,bhkd->bhqk", q[:, :, r0:r1].float(),
                         kf) * scale
        mask = (kpos < sk_actual)[None, :]
        if causal:
            qpos = torch.arange(r0, r1, device=q.device) + kv_offset
            mask = mask & (kpos[None, :] <= qpos[:, None])
        s = torch.where(mask, s, torch.full((), NEG_INF, device=q.device))
        m = s.amax(-1, keepdim=True)
        p = torch.where(mask, torch.exp(s - m),
                        torch.zeros((), device=q.device))
        l = p.sum(-1, keepdim=True)
        o = torch.einsum("bhqk,bhkd->bhqd", p, vf)
        out[:, :, r0:r1] = (o / torch.where(l > 0, l, torch.ones_like(l))
                            ).to(q.dtype)
    return out
