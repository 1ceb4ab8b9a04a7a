"""Attention layers (port of ``repro.models.attention``): GQA with optional
qk_norm and QKV bias.

Two execution modes per layer:
  * full-sequence (prefill): softmax attention over the whole sequence,
    through K2 by default (``attn_impl="k2"``) or the plain ``_sdpa``
    (``attn_impl="sdpa"``). These are the reference's ``"pallas"`` and
    ``"xla"``: K2 is the CUDA kernel for CUDA tensors and its plain version
    for CPU tensors, as the reference's ``"pallas"`` is its Pallas kernel.
  * cached decode: one new token against a preallocated dense KV cache,
    through ``_sdpa`` (the reference computes it outside any kernel).

The KV caches are updated in place (the reference returns new arrays):
at full width a copy per token would move the whole cache.

DeepSeek MLA is not ported yet (ROADMAP.md Queue 1 item 17, "MLA").
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch.profiler import record_function

from ..configs.base import ArchConfig
from ..kernels import ops as kops
from .layers import ParamSet, ShapeDtype, rms_norm, rope

ATTN_IMPLS = ("k2", "sdpa")     # the reference's "pallas" and "xla"
_MLA_TODO = ("MLA attention is not ported yet (ROADMAP.md Queue 1 item 17, "
             "MLA family)")


# ---------------------------------------------------------------------------
# Parameter registration
# ---------------------------------------------------------------------------

def register_attn(ps: ParamSet, prefix: str, cfg: ArchConfig,
                  stack: Tuple[int, ...]) -> None:
    """GQA projection weights. ``stack`` is the leading block dims."""
    d, h, hk, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    s = tuple(stack)
    ns = (None,) * len(s)
    ps.add(f"{prefix}/wq", s + (d, h * dh), ns + ("fsdp", "tp"))
    ps.add(f"{prefix}/wk", s + (d, hk * dh), ns + ("fsdp", "tp"))
    ps.add(f"{prefix}/wv", s + (d, hk * dh), ns + ("fsdp", "tp"))
    ps.add(f"{prefix}/wo", s + (h * dh, d), ns + ("tp", "fsdp"))
    if cfg.qkv_bias:
        ps.add(f"{prefix}/bq", s + (h * dh,), ns + ("tp",), init="zeros")
        ps.add(f"{prefix}/bk", s + (hk * dh,), ns + ("tp",), init="zeros")
        ps.add(f"{prefix}/bv", s + (hk * dh,), ns + ("tp",), init="zeros")
    if cfg.qk_norm:
        ps.add(f"{prefix}/q_norm", s + (dh,), ns + (None,), init="ones")
        ps.add(f"{prefix}/k_norm", s + (dh,), ns + (None,), init="ones")
    ps.add(f"{prefix}/norm", s + (d,), ns + (None,), init="ones")


def register_mla(ps: ParamSet, prefix: str, cfg: ArchConfig,
                 stack: Tuple[int, ...]) -> None:
    raise NotImplementedError(_MLA_TODO)


# ---------------------------------------------------------------------------
# Core softmax attention (plain path)
# ---------------------------------------------------------------------------

def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
          kv_len: Optional[int] = None) -> torch.Tensor:
    """q: (B,H,Sq,Dh); k,v: (B,Hkv,Sk,Dh'). Returns (B,H,Sq,Dv).

    Masks with −1e30 (a row with no visible key gets the mean of V), scores
    divided by √Dh — as the reference."""
    b, h, sq, dh = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    g = h // hkv
    qg = q.reshape(b, hkv, g, sq, dh)
    logits = torch.einsum("bkgqd,bksd->bkgqs", qg.float(),
                          k.float()) / (dh ** 0.5)
    kpos = torch.arange(sk, device=q.device)
    neg = torch.full((), -1e30, dtype=torch.float32, device=q.device)
    if causal:
        qpos = torch.arange(sq, device=q.device) + (sk - sq)
        logits = torch.where(kpos[None, :] <= qpos[:, None], logits, neg)
    if kv_len is not None:   # decode: mask unwritten cache slots
        logits = torch.where(kpos < kv_len, logits, neg)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bksd->bkgqd", p, v.float())
    return out.reshape(b, h, sq, v.shape[-1]).to(q.dtype)


def _split_heads(x: torch.Tensor, n: int) -> torch.Tensor:
    b, s, _ = x.shape
    return x.reshape(b, s, n, -1).transpose(1, 2)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, s, d = x.shape
    return x.transpose(1, 2).reshape(b, s, h * d)


# ---------------------------------------------------------------------------
# GQA layer
# ---------------------------------------------------------------------------

def _qkv(p: Dict, x: torch.Tensor, cfg: ArchConfig
         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    xn = rms_norm(x, p["norm"], cfg.norm_eps)
    q = torch.matmul(xn, p["wq"])
    k = torch.matmul(xn, p["wk"])
    v = torch.matmul(xn, p["wv"])
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = _split_heads(q, cfg.n_heads)
    k = _split_heads(k, cfg.n_kv_heads)
    v = _split_heads(v, cfg.n_kv_heads)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    return q, k, v


def gqa_full(p: Dict, x: torch.Tensor, cfg: ArchConfig, causal: bool = True,
             positions: Optional[torch.Tensor] = None, attn_impl: str = "k2"
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full-sequence GQA. Returns (output, kv_for_cache)."""
    if attn_impl not in ATTN_IMPLS:
        raise ValueError(f"attn_impl must be one of {ATTN_IMPLS}, got "
                         f"{attn_impl!r}")
    s = x.shape[1]
    q, k, v = _qkv(p, x, cfg)
    pos = positions if positions is not None else torch.arange(
        s, device=x.device)
    q = rope(q, pos, cfg.rope_theta)
    k = rope(k, pos, cfg.rope_theta)
    if attn_impl == "k2":
        with record_function("attn/k2"):
            o = kops.flash_attention(q, k, v, causal=causal)
    else:
        o = _sdpa(q, k, v, causal)
    out = torch.matmul(_merge_heads(o), p["wo"])
    return x + out, {"k": k, "v": v}


def gqa_decode(p: Dict, x: torch.Tensor, cache: Dict[str, torch.Tensor],
               cur_len: int, cfg: ArchConfig
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token decode. x: (B, 1, D); cache k/v: (B, Hkv, S_max, Dh),
    written in place at ``cur_len`` (one position shared by the batch, as
    in the reference). Returns (output, cache)."""
    q, k, v = _qkv(p, x, cfg)
    pos = torch.full((1, 1, 1), cur_len, dtype=torch.int64, device=x.device)
    q = rope(q, pos, cfg.rope_theta)
    k = rope(k, pos, cfg.rope_theta)
    kc, vc = cache["k"], cache["v"]
    kc[:, :, cur_len, :] = k[:, :, 0, :]
    vc[:, :, cur_len, :] = v[:, :, 0, :]
    o = _sdpa(q, kc, vc, causal=False, kv_len=cur_len + 1)
    out = torch.matmul(_merge_heads(o), p["wo"])
    return x + out, {"k": kc, "v": vc}


def gqa_cache_spec(cfg: ArchConfig, batch: int, s_max: int,
                   dtype: torch.dtype) -> Dict[str, ShapeDtype]:
    shp = (batch, cfg.n_kv_heads, s_max, cfg.d_head)
    return {"k": ShapeDtype(shp, dtype), "v": ShapeDtype(shp, dtype)}


# ---------------------------------------------------------------------------
# MLA layer (DeepSeek-V2): not ported yet
# ---------------------------------------------------------------------------

def mla_full(p: Dict, x: torch.Tensor, cfg: ArchConfig, causal: bool = True):
    raise NotImplementedError(_MLA_TODO)


def mla_decode(p: Dict, x: torch.Tensor, cache: Dict[str, torch.Tensor],
               cur_len: int, cfg: ArchConfig):
    raise NotImplementedError(_MLA_TODO)
