"""Attention layers (port of ``repro.models.attention``): GQA with optional
qk_norm and QKV bias, and DeepSeek MLA.

Two execution modes per layer:
  * full-sequence (prefill): softmax attention over the whole sequence,
    through K2 by default (``attn_impl="k2"``) or the plain ``_sdpa``
    (``attn_impl="sdpa"``). These are the reference's ``"pallas"`` and
    ``"xla"``: K2 is the CUDA kernel for CUDA tensors and its plain version
    for CPU tensors, as the reference's ``"pallas"`` is its Pallas kernel.
  * cached decode: one new token against a preallocated dense KV cache,
    through ``_sdpa`` (the reference computes it outside any kernel).

MLA runs outside any kernel in both modes, as in the reference, whatever
``attn_impl`` says: the full sequence materialises keys and values from
the compressed ``c_kv`` and calls ``_sdpa`` (query and key width
nope + rope, value width ``v_head_dim``); decode keeps only ``c_kv`` and
the rope key in its cache and absorbs ``w_uk`` / ``w_uv`` into the query
and the context.

The KV caches are updated in place (the reference returns new arrays):
at full width a copy per token would move the whole cache.

In training over a model axis of T ranks (``tp``, ``models/sharding.py``)
GQA is Megatron's: the normed input goes to every model rank
(``sharding.to_model``), ``wq`` / ``wk`` / ``wv`` (and the biases) are
column blocks holding the rank's ``n_heads / T`` query heads and
``n_kv_heads / T`` kv heads, so query head h still reads kv head
h // group on the same rank; ``wo`` is a row block whose partial output
is summed over the model ranks at the reference's ``(batch, None, None)``
hint. The qk-norm weights act on every rank's heads, so their gradient
is summed over the model ranks too. MLA is split the same way: ``wq``,
``w_uk`` and ``w_uv`` are column blocks of the rank's ``n_heads / T``
heads and ``wo`` a row block; the compressed ``c_kv`` and the shared rope
key are made on every rank from the replicated ``w_dkv``, ``w_kpe`` and
``kv_norm``, which feed only the rank's heads there, so those three enter
through ``sharding.to_model`` and their gradients are summed over the
model ranks. Serving over a model axis (a serve tree,
``sharding.for_serve``) runs both modes so: ``gqa_full`` through K2 on
the rank's heads, ``gqa_decode`` against a cache of the rank's kv heads,
``mla_decode`` on the rank's heads against the whole compressed cache.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch.profiler import record_function

from ..configs.base import ArchConfig
from ..kernels import ops as kops
from . import sharding
from .layers import ParamSet, ShapeDtype, hint, rms_norm, rope

ATTN_IMPLS = ("k2", "sdpa")     # the reference's "pallas" and "xla"


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
    """DeepSeek-V2 MLA: compressed KV (kv_lora_rank) + decoupled rope key."""
    d, h = cfg.d_model, cfg.n_heads
    r, dn, dr, dv = (cfg.kv_lora_rank, cfg.qk_nope_dim, cfg.qk_rope_dim,
                     cfg.v_head_dim)
    s = tuple(stack)
    ns = (None,) * len(s)
    ps.add(f"{prefix}/wq", s + (d, h * (dn + dr)), ns + ("fsdp", "tp"))
    ps.add(f"{prefix}/w_dkv", s + (d, r), ns + ("fsdp", None))      # down
    ps.add(f"{prefix}/w_kpe", s + (d, dr), ns + ("fsdp", None))     # rope key
    ps.add(f"{prefix}/w_uk", s + (r, h * dn), ns + (None, "tp"))    # up: key
    ps.add(f"{prefix}/w_uv", s + (r, h * dv), ns + (None, "tp"))    # up: value
    ps.add(f"{prefix}/wo", s + (h * dv, d), ns + ("tp", "fsdp"))
    ps.add(f"{prefix}/norm", s + (d,), ns + (None,), init="ones")
    ps.add(f"{prefix}/kv_norm", s + (r,), ns + (None,), init="ones")


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

def _proj(p: Dict, x: torch.Tensor, cfg: ArchConfig,
          tp: Optional[sharding.ModelAxis] = None
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q, k, v projections of the normed x, heads not yet split (with
    ``tp``, the rank's column blocks of them)."""
    xn = sharding.to_model(rms_norm(x, p["norm"], cfg.norm_eps), tp)
    return (torch.matmul(xn, p["wq"]), torch.matmul(xn, p["wk"]),
            torch.matmul(xn, p["wv"]))


def _heads(p: Dict, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           cfg: ArchConfig, tp: Optional[sharding.ModelAxis] = None
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Bias, heads split (the rank's own with ``tp``), qk-norm."""
    t = 1 if tp is None else tp.size
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = _split_heads(q, cfg.n_heads // t)
    k = _split_heads(k, cfg.n_kv_heads // t)
    v = _split_heads(v, cfg.n_kv_heads // t)
    if cfg.qk_norm:
        q = rms_norm(q, sharding.to_model(p["q_norm"], tp), cfg.norm_eps)
        k = rms_norm(k, sharding.to_model(p["k_norm"], tp), cfg.norm_eps)
    return q, k, v


def gqa_full(p: Dict, x: torch.Tensor, cfg: ArchConfig, causal: bool = True,
             positions: Optional[torch.Tensor] = None, attn_impl: str = "k2",
             tp: Optional[sharding.ModelAxis] = None
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full-sequence GQA. Returns (output, kv_for_cache). With ``tp``, on
    the rank's heads (the cache entries are its kv heads)."""
    if attn_impl not in ATTN_IMPLS:
        raise ValueError(f"attn_impl must be one of {ATTN_IMPLS}, got "
                         f"{attn_impl!r}")
    s = x.shape[1]
    q, k, v = _proj(p, x, cfg, tp)
    q = hint(q, "batch", None, "tp")
    k = hint(k, "batch", None, "tp")
    v = hint(v, "batch", None, "tp")
    q, k, v = _heads(p, q, k, v, cfg, tp)
    pos = positions if positions is not None else torch.arange(
        s, device=x.device)
    q = rope(q, pos, cfg.rope_theta)
    k = rope(k, pos, cfg.rope_theta)
    if attn_impl == "k2":
        with record_function("attn/k2"):
            o = kops.flash_attention(q, k, v, causal=causal)
    else:
        o = _sdpa(q, k, v, causal)
    out = sharding.from_model(torch.matmul(_merge_heads(o), p["wo"]), tp)
    return x + hint(out, "batch", None, None), {"k": k, "v": v}


def gqa_decode(p: Dict, x: torch.Tensor, cache: Dict[str, torch.Tensor],
               cur_len: int, cfg: ArchConfig,
               tp: Optional[sharding.ModelAxis] = None
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token decode. x: (B, 1, D); cache k/v: (B, Hkv, S_max, Dh),
    written in place at ``cur_len`` (one position shared by the batch, as
    in the reference). Returns (output, cache). With ``tp`` on the rank's
    heads, as :func:`gqa_full`: the cache holds its ``n_kv_heads / T``
    kv heads and ``wo``'s partial output is summed over the model
    ranks."""
    q, k, v = _heads(p, *_proj(p, x, cfg, tp), cfg, tp)
    pos = torch.full((1, 1, 1), cur_len, dtype=torch.int64, device=x.device)
    q = rope(q, pos, cfg.rope_theta)
    k = rope(k, pos, cfg.rope_theta)
    kc, vc = cache["k"], cache["v"]
    kc[:, :, cur_len, :] = k[:, :, 0, :]
    vc[:, :, cur_len, :] = v[:, :, 0, :]
    o = _sdpa(q, kc, vc, causal=False, kv_len=cur_len + 1)
    out = sharding.from_model(torch.matmul(_merge_heads(o), p["wo"]), tp)
    return x + out, {"k": kc, "v": vc}


def gqa_cache_spec(cfg: ArchConfig, batch: int, s_max: int,
                   dtype: torch.dtype, model_ranks: int = 1
                   ) -> Dict[str, ShapeDtype]:
    """K and V of one layer; over ``model_ranks`` a rank's kv heads."""
    shp = (batch, cfg.n_kv_heads // model_ranks, s_max, cfg.d_head)
    return {"k": ShapeDtype(shp, dtype), "v": ShapeDtype(shp, dtype)}


# ---------------------------------------------------------------------------
# MLA layer (DeepSeek-V2): full sequence materialised; decode absorbed
# ---------------------------------------------------------------------------

def _mla_q(p: Dict, xn: torch.Tensor, cfg: ArchConfig, pos: torch.Tensor
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(q_nope, roped q_pe), each (B, H, S, ·): H the heads of ``wq``'s
    columns (the rank's under TP)."""
    b, s, _ = xn.shape
    dn = cfg.qk_nope_dim
    q = torch.matmul(xn, p["wq"]).reshape(b, s, -1, dn + cfg.qk_rope_dim)
    q = q.transpose(1, 2)
    return q[..., :dn], rope(q[..., dn:], pos, cfg.rope_theta)


def _mla_kv(p: Dict, xn: torch.Tensor, cfg: ArchConfig, pos: torch.Tensor,
            tp: Optional[sharding.ModelAxis] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(c_kv (B, S, r) normalised, roped k_pe (B, 1, S, dr)). With ``tp``
    they feed only the rank's heads, so ``w_dkv``, ``w_kpe`` and
    ``kv_norm`` enter through ``to_model`` (their gradients summed over
    the model ranks)."""
    w_dkv, w_kpe, kv_norm = (sharding.to_model(p[k], tp)
                             for k in ("w_dkv", "w_kpe", "kv_norm"))
    c_kv = rms_norm(torch.matmul(xn, w_dkv), kv_norm, cfg.norm_eps)
    k_pe = rope(torch.matmul(xn, w_kpe)[:, None], pos, cfg.rope_theta)
    return c_kv, k_pe


def mla_full(p: Dict, x: torch.Tensor, cfg: ArchConfig, causal: bool = True,
             tp: Optional[sharding.ModelAxis] = None
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full-sequence MLA through ``_sdpa``. Returns (output, {"c_kv" (B, S,
    r), "k_pe" (B, S, dr)}). With ``tp``, on the rank's heads: the normed
    input goes to every model rank, ``wo``'s partial output is summed over
    them."""
    b, s, _ = x.shape
    t = 1 if tp is None else tp.size
    h, dn, dv = cfg.n_heads // t, cfg.qk_nope_dim, cfg.v_head_dim
    xn = sharding.to_model(rms_norm(x, p["norm"], cfg.norm_eps), tp)
    pos = torch.arange(s, device=x.device)
    q_nope, q_pe = _mla_q(p, xn, cfg, pos)
    c_kv, k_pe = _mla_kv(p, xn, cfg, pos, tp)
    k_nope = torch.matmul(c_kv, p["w_uk"]).reshape(b, s, h, dn).transpose(1, 2)
    v = torch.matmul(c_kv, p["w_uv"]).reshape(b, s, h, dv).transpose(1, 2)
    qf = torch.cat([q_nope, q_pe], dim=-1)
    kf = torch.cat([k_nope, k_pe.expand(b, h, s, k_pe.shape[-1])], dim=-1)
    o = _sdpa(qf, kf, v, causal)
    out = sharding.from_model(torch.matmul(_merge_heads(o), p["wo"]), tp)
    return x + out, {"c_kv": c_kv, "k_pe": k_pe[:, 0]}


def mla_decode(p: Dict, x: torch.Tensor, cache: Dict[str, torch.Tensor],
               cur_len: int, cfg: ArchConfig,
               tp: Optional[sharding.ModelAxis] = None
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Absorbed-weight one-token decode. x: (B, 1, D); cache ``c_kv`` (B,
    S_max, r) and ``k_pe`` (B, S_max, dr), written in place at
    ``cur_len``. The absorbed query is in the activation dtype, the scores,
    softmax and context in f32, as in the reference. Returns (output,
    cache). With ``tp`` on the rank's ``n_heads / T`` heads (the absorbed
    query, ``w_uk`` and ``w_uv`` by ``reshape(r, h/T, ·)``), ``wo``'s
    partial output summed over the model ranks; ``c_kv`` and ``k_pe`` are
    whole on every rank, each computing them from the replicated
    ``w_dkv``, ``w_kpe`` and ``kv_norm``, so the cache is the one-device
    cache."""
    t = 1 if tp is None else tp.size
    h = cfg.n_heads // t
    dn, dr, dv, r = (cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim,
                     cfg.kv_lora_rank)
    xn = sharding.to_model(rms_norm(x, p["norm"], cfg.norm_eps), tp)
    pos = torch.full((1, 1, 1), cur_len, dtype=torch.int64, device=x.device)
    q_nope, q_pe = _mla_q(p, xn, cfg, pos)                        # (B,h,1,·)
    c_new, kpe_new = _mla_kv(p, xn, cfg, pos, tp)
    c_kv, k_pe = cache["c_kv"], cache["k_pe"]
    c_kv[:, cur_len, :] = c_new[:, 0]
    k_pe[:, cur_len, :] = kpe_new[:, 0, 0]

    # absorb w_uk into the query: score = (q_nope w_ukᵀ)·c_kv + q_pe·k_pe
    q_abs = torch.einsum("bhsd,rhd->bhsr", q_nope,
                         p["w_uk"].reshape(r, h, dn))             # (B,h,1,r)
    c32 = c_kv.float()
    logits = (torch.einsum("bhsr,btr->bhst", q_abs.float(), c32)
              + torch.einsum("bhsr,btr->bhst", q_pe.float(), k_pe.float())
              ) / ((dn + dr) ** 0.5)
    mask = torch.arange(c_kv.shape[1], device=x.device) < cur_len + 1
    logits = torch.where(mask, logits, torch.full((), -1e30,
                                                  dtype=torch.float32,
                                                  device=x.device))
    pr = torch.softmax(logits, dim=-1)
    ctx = torch.einsum("bhst,btr->bhsr", pr, c32)                 # (B,h,1,r)
    o = torch.einsum("bhsr,rhv->bhsv", ctx,
                     p["w_uv"].reshape(r, h, dv).float()).to(x.dtype)
    out = sharding.from_model(torch.matmul(_merge_heads(o), p["wo"]), tp)
    return x + out, {"c_kv": c_kv, "k_pe": k_pe}


def mla_cache_spec(cfg: ArchConfig, batch: int, s_max: int,
                   dtype: torch.dtype) -> Dict[str, ShapeDtype]:
    return {"c_kv": ShapeDtype((batch, s_max, cfg.kv_lora_rank), dtype),
            "k_pe": ShapeDtype((batch, s_max, cfg.qk_rope_dim), dtype)}
