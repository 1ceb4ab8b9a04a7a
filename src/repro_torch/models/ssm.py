"""Mamba2 — SSD (state-space duality), chunked prefill + O(1) decode (port
of ``repro.models.ssm``).

The chunked SSD algorithm (Dao & Gu 2024): split the sequence into chunks
of length L; within a chunk the output is a masked (decay-weighted)
attention-like quadratic form; across chunks a (B, H, P, N) state is
carried. Decode is a pure recurrence on that state.

The SSD is plain ``torch.einsum`` / ``torch.matmul`` in f32, as the
reference computes it with XLA einsums outside any Pallas kernel. The
reference's ``jax.lax.scan`` over chunks is a Python loop over the C
chunks, adding in the same order. One departure on purpose: the intra-chunk
decay masks its exponent before the ``exp`` (ROADMAP.md), so its gradient
stays finite at the configs' chunk of 128, where the reference's is NaN.

Over a model axis of T ranks (``tp``, ``models/sharding.py``)
``ssm_full`` and ``ssm_decode`` run on the rank's h / T heads. In training
the storage stays in the reference's fused layout and is gathered over the
model group each call (:func:`_rank_proj`); a serve tree holds the rank's
columns and parts instead (:func:`serve_leaves`, once at set-up).

Decode caches per layer: the pre-conv window ``conv`` (B, d_conv − 1, C)
and the SSM ``state`` (B, H, P, N), both in the activation dtype.
``ssm_decode`` writes them in place (``copy_``), as the port's attention
caches are written: ``LM.decode_step`` hands each layer views of the
stacked caches.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from . import sharding
from .layers import ParamSet, ShapeDtype, hint, rms_norm


def _dims(cfg: ArchConfig) -> Tuple[int, int, int, int]:
    d_inner = cfg.ssm_expand * cfg.d_model
    n_heads = d_inner // cfg.ssm_head_dim
    return d_inner, n_heads, cfg.ssm_head_dim, cfg.ssm_state


def register_ssm(ps: ParamSet, prefix: str, cfg: ArchConfig,
                 stack: Tuple[int, ...]) -> None:
    d = cfg.d_model
    di, h, hp, n = _dims(cfg)
    conv_dim = di + 2 * n                     # conv over (x, B, C)
    s = tuple(stack)
    ns = (None,) * len(s)
    # in_proj → [z (di), x (di), B (n), C (n), dt (h)]
    ps.add(f"{prefix}/w_in", s + (d, 2 * di + 2 * n + h), ns + ("fsdp", "tp"))
    ps.add(f"{prefix}/conv_w", s + (cfg.ssm_conv, conv_dim), ns + (None, "tp"))
    ps.add(f"{prefix}/conv_b", s + (conv_dim,), ns + ("tp",), init="zeros")
    ps.add(f"{prefix}/a_log", s + (h,), ns + (None,), init="zeros")
    ps.add(f"{prefix}/dt_bias", s + (h,), ns + (None,), init="zeros")
    ps.add(f"{prefix}/d_skip", s + (h,), ns + (None,), init="ones")
    ps.add(f"{prefix}/out_norm", s + (di,), ns + (None,), init="ones")
    ps.add(f"{prefix}/w_out", s + (di, d), ns + ("tp", "fsdp"))
    ps.add(f"{prefix}/norm", s + (d,), ns + (None,), init="ones")


def _split_proj(cfg: ArchConfig, proj: torch.Tensor, t: int = 1
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """z, the conv's input (x, B, C) and dt of a projection whose columns
    hold ``1/t`` of the heads (:func:`_rank_proj`'s layout; all of them
    at ``t`` 1)."""
    di, h, hp, n = _dims(cfg)
    di //= t
    z = proj[..., :di]
    xbc = proj[..., di:di + di + 2 * n]
    dt = proj[..., di + di + 2 * n:]
    return z, xbc, dt


def _rank_proj(p: Dict, cfg: ArchConfig, tp: sharding.ModelAxis
               ) -> Tuple[torch.Tensor, ...]:
    """``w_in``, ``conv_w`` and ``conv_b`` for this rank's heads
    ``[r·h/T, (r+1)·h/T)``: each TP block made whole over the model group
    (``sharding.gather_model``: the reference's fused ``(fsdp, tp)``
    layout cuts across z, x, B, C and dt), then the columns of the rank's
    z, x and dt and all of B and C, in the reference's order (the conv's
    channels: the rank's x, B, C). B and C's columns and channels are
    every rank's: the gather's reduce-scatter sums their gradients over
    the model ranks. On a serve tree (``tp.serving``) the leaves are
    those columns already (:func:`serve_leaves`)."""
    if tp.serving:
        return p["w_in"], p["conv_w"], p["conv_b"]
    di, h, _, n = _dims(cfg)
    return _rank_columns(p, di, h, n, tp)


def _rank_columns(p: Dict, di: int, h: int, n: int,
                  tp: sharding.ModelAxis) -> Tuple[torch.Tensor, ...]:
    """:func:`_rank_proj` of a layer of ``d_inner`` ``di``, ``h`` heads
    and state ``n``."""
    r, t = tp.rank, tp.size
    dl, hl = di // t, h // t
    w_in, conv_w, conv_b = (sharding.gather_model(p[k], p[k].dim() - 1, tp)
                            for k in ("w_in", "conv_w", "conv_b"))
    cols = (slice(r * dl, (r + 1) * dl),                      # z
            slice(di + r * dl, di + (r + 1) * dl),            # x
            slice(2 * di, 2 * di + 2 * n),                    # B, C
            slice(2 * di + 2 * n + r * hl, 2 * di + 2 * n + (r + 1) * hl))
    chans = (slice(r * dl, (r + 1) * dl), slice(di, di + 2 * n))
    return (torch.cat([w_in[..., c] for c in cols], dim=-1),
            torch.cat([conv_w[..., c] for c in chans], dim=-1),
            torch.cat([conv_b[..., c] for c in chans], dim=-1))


def _rank_part(w: torch.Tensor, tp: Optional[sharding.ModelAxis]
               ) -> torch.Tensor:
    """This rank's block of a leaf the reference keeps whole on every
    model rank (``a_log``, ``dt_bias``, ``d_skip``, ``out_norm``), its
    gradient summed over the model ranks (``sharding.to_model``); the
    leaf itself without ``tp`` or on a serve tree (``tp.serving``: the
    part already)."""
    if tp is None or tp.serving:
        return w
    m = w.shape[-1] // tp.size
    return sharding.to_model(w, tp)[..., tp.rank * m:(tp.rank + 1) * m]


_PARTS = ("a_log", "dt_bias", "d_skip", "out_norm")


def serve_leaves(p: Dict, tp: sharding.ModelAxis) -> Dict:
    """An SSM layer's leaves (TP blocks, any leading stack dims) for a
    serve tree (``sharding.for_serve``): ``w_in``, ``conv_w`` and
    ``conv_b`` replaced by this rank's columns (:func:`_rank_proj`, its
    gathers made here once) and ``a_log``, ``dt_bias``, ``d_skip`` and
    ``out_norm`` by this rank's part; the others as they are. The config's
    dims are read off the leaves (``a_log`` has the heads, ``out_norm``
    ``d_inner``, ``conv_b`` a block of ``d_inner + 2·state``)."""
    h, di = p["a_log"].shape[-1], p["out_norm"].shape[-1]
    n = (p["conv_b"].shape[-1] * tp.size - di) // 2
    out = dict(p)
    out["w_in"], out["conv_w"], out["conv_b"] = _rank_columns(p, di, h, n,
                                                              tp)
    for k in _PARTS:
        m = p[k].shape[-1] // tp.size
        out[k] = p[k][..., tp.rank * m:(tp.rank + 1) * m].contiguous()
    return out


def _gated_norm(y: torch.Tensor, w: torch.Tensor, eps: float,
                tp: Optional[sharding.ModelAxis]) -> torch.Tensor:
    """``rms_norm`` over the whole ``d_inner``: with ``tp``, of which this
    rank holds 1/T, the f32 sum of squares summed over the model ranks
    (``sharding.sum_over_model``) before the mean."""
    if tp is None:
        return rms_norm(y, w, eps)
    dt = y.dtype
    y = y.float()
    ss = sharding.sum_over_model(torch.sum(y * y, dim=-1, keepdim=True), tp)
    var = ss / (y.shape[-1] * tp.size)
    return (y * torch.rsqrt(var + eps)).to(dt) * w


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 prev: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv over time. xbc: (B, S, C); w: (K, C). The K
    taps are summed one after another in the activation dtype, as the
    reference sums them (``F.conv1d`` would accumulate otherwise)."""
    k = w.shape[0]
    s = xbc.shape[1]
    if prev is None:
        prev = torch.zeros((xbc.shape[0], k - 1, xbc.shape[2]),
                           dtype=xbc.dtype, device=xbc.device)
    xp = torch.cat([prev, xbc], dim=1)                        # (B, S+K-1, C)
    out = xp[:, 0:s, :] * w[0]
    for i in range(1, k):
        out = out + xp[:, i:i + s, :] * w[i]
    return F.silu(out + b)


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                bmat: torch.Tensor, cmat: torch.Tensor, chunk: int,
                h0: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SSD over a full sequence.

    x: (B,S,H,P); dt: (B,S,H) (post-softplus); a: (H,) (negative);
    bmat/cmat: (B,S,N). Returns (y (B,S,H,P), final state (B,H,P,N)).
    """
    b, s, h, p = x.shape
    n = bmat.shape[-1]
    l = min(chunk, s)
    assert s % l == 0, (s, l)
    c = s // l
    xc = x.reshape(b, c, l, h, p)
    dtc = dt.reshape(b, c, l, h)
    bc = bmat.reshape(b, c, l, n)
    cc = cmat.reshape(b, c, l, n)

    da = dtc * a                                              # (B,C,L,H) ≤ 0
    cum = torch.cumsum(da, dim=2)                             # within-chunk
    # intra-chunk decay matrix: exp(cum_i - cum_j) for j <= i
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]      # (B,C,L,L,H)
    # masked before the exp, out of place: above the diagonal diff ≥ 0 sums
    # up to ~L·dt·|a|, whose exp overflows at L 128 and would make the masked
    # gradient 0·inf = NaN (the reference's ssm.py:94 takes it after the
    # exp); exp(-inf) is exactly 0, so the forward is the same bit for bit
    mask = torch.tril(torch.ones((l, l), dtype=torch.bool, device=x.device))
    decay = torch.exp(diff.masked_fill(~mask[None, None, :, :, None],
                                       float("-inf")))
    scores = torch.einsum("bcln,bcmn->bclm", cc, bc)          # (B,C,L,L)
    w = scores[..., None] * decay * dtc[:, :, None, :, :]     # (B,C,L,L,H)
    y_intra = torch.einsum("bclmh,bcmhp->bclhp", w, xc)

    # chunk states: contribution of each chunk to the carried state
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)         # (B,C,L,H)
    st = torch.einsum("bcln,bclhp->bchpn", bc,
                      (dtc * decay_to_end)[..., None] * xc)   # (B,C,H,P,N)
    chunk_decay = torch.exp(cum[:, :, -1, :])                 # (B,C,H)

    hprev = h0 if h0 is not None else torch.zeros(
        (b, h, p, n), dtype=x.dtype, device=x.device)
    hprevs = []
    for i in range(c):                      # the reference's scan over chunks
        hprevs.append(hprev)
        hprev = hprev * chunk_decay[:, i, :, None, None] + st[:, i]
    hprevs = torch.stack(hprevs, dim=1)                       # (B,C,H,P,N)

    # inter-chunk: y += C · (decay_in * h_prev)
    decay_in = torch.exp(cum)                                 # (B,C,L,H)
    y_inter = torch.einsum("bcln,bchpn->bclhp", cc,
                           hprevs) * decay_in[..., None]
    y = (y_intra + y_inter).reshape(b, s, h, p)
    return y, hprev


def ssm_full(p: Dict, x: torch.Tensor, cfg: ArchConfig,
             tp: Optional[sharding.ModelAxis] = None
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full-sequence Mamba2 block. Returns (out, cache for the decode
    hand-off: the pre-conv tail window and the final SSM state). With
    ``tp`` on the rank's heads (Megatron's Mamba2 with one group): the
    normed input goes to every model rank, the projection, conv and SSD
    run on the rank's z, x and dt with all of B and C (:func:`_rank_proj`),
    the gated norm over the rank's channels with its sum of squares summed
    over the model ranks, ``w_out`` a row block whose partial output is
    summed over them; the cache holds the rank's channels and heads."""
    b, s, d = x.shape
    di, h, hp, n = _dims(cfg)
    t = 1 if tp is None else tp.size
    dl, hl = di // t, h // t
    xn = sharding.to_model(rms_norm(x, p["norm"], cfg.norm_eps), tp)
    w_in, conv_w, conv_b = ((p["w_in"], p["conv_w"], p["conv_b"])
                            if tp is None else _rank_proj(p, cfg, tp))
    proj = hint(torch.matmul(xn, w_in), "batch", None, None)
    z, xbc_raw, dt = _split_proj(cfg, proj, t)
    xbc = _causal_conv(xbc_raw, conv_w, conv_b)
    xin = xbc[..., :dl].reshape(b, s, hl, hp)
    bmat = xbc[..., dl:dl + n]
    cmat = xbc[..., dl + n:]
    dt = F.softplus(dt.float() + _rank_part(p["dt_bias"], tp))
    a = -torch.exp(_rank_part(p["a_log"], tp).float())
    # pad S to a chunk multiple with identity timesteps (dt=0 ⇒ decay=1 and
    # zero state contribution), so the carried state is unaffected
    l = min(cfg.ssm_chunk, s) if s % min(cfg.ssm_chunk, s) == 0 \
        else cfg.ssm_chunk
    pad = -(-s // l) * l - s
    if pad:
        xin_p = F.pad(xin, (0, 0, 0, 0, 0, pad))
        dt_p, b_p, c_p = (F.pad(u, (0, 0, 0, pad)) for u in (dt, bmat, cmat))
    else:
        xin_p, dt_p, b_p, c_p = xin, dt, bmat, cmat
    y, hfin = ssd_chunked(xin_p.float(), dt_p, a, b_p.float(), c_p.float(),
                          l)
    y = y[:, :s]
    y = y + xin.float() * _rank_part(p["d_skip"], tp)[:, None]
    y = y.reshape(b, s, dl).to(x.dtype)
    y = _gated_norm(y * F.silu(z), _rank_part(p["out_norm"], tp),
                    cfg.norm_eps, tp)
    out = hint(sharding.from_model(torch.matmul(y, p["w_out"]), tp),
               "batch", None, None)
    # decode hand-off: the *pre-conv* tail window (left-padded with zeros
    # when S < K−1) + the final SSM state in the activation dtype; the
    # tail is copied out of ``proj`` so the cache does not hold it
    kw = cfg.ssm_conv - 1
    conv_tail = (xbc_raw[:, s - kw:, :].clone() if s >= kw
                 else F.pad(xbc_raw, (0, 0, kw - s, 0)))
    cache = {"conv": conv_tail, "state": hfin.to(x.dtype)}
    return x + out, cache


def ssm_decode(p: Dict, x: torch.Tensor, cache: Dict[str, torch.Tensor],
               cfg: ArchConfig, tp: Optional[sharding.ModelAxis] = None
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token recurrence. x: (B, 1, D); cache: conv window (B, K−1, C)
    and SSM state (B, H, P, N), both written in place: the window shifts
    by one, the state is stepped in f32 and stored in the cache's dtype,
    as the reference returns it. Returns (output, cache). With ``tp`` on
    the rank's h / T heads, as ``ssm_full``: the window holds the rank's
    channels in :func:`_rank_proj`'s order (its x, then all of B and C)
    and the state its heads; the gated norm's sum of squares and
    ``w_out``'s partial output are summed over the model ranks."""
    b = x.shape[0]
    di, h, hp, n = _dims(cfg)
    t = 1 if tp is None else tp.size
    dl, hl = di // t, h // t
    xn = sharding.to_model(rms_norm(x, p["norm"], cfg.norm_eps), tp)
    w_in, conv_w, conv_b = ((p["w_in"], p["conv_w"], p["conv_b"])
                            if tp is None else _rank_proj(p, cfg, tp))
    proj = torch.matmul(xn, w_in)
    z, xbc_new, dt = _split_proj(cfg, proj, t)

    window = torch.cat([cache["conv"], xbc_new], dim=1)        # (B,K,C)
    k = conv_w.shape[0]
    conv_out = torch.einsum("bkc,kc->bc", window[:, -k:, :], conv_w)
    xbc = F.silu(conv_out + conv_b)[:, None, :]                # (B,1,C)

    xin = xbc[..., :dl].reshape(b, hl, hp)
    bmat = xbc[:, 0, dl:dl + n]
    cmat = xbc[:, 0, dl + n:]
    dt1 = F.softplus(dt[:, 0].float() + _rank_part(p["dt_bias"], tp))
    a = -torch.exp(_rank_part(p["a_log"], tp).float())
    decay = torch.exp(dt1 * a)                                 # (B,H)
    state = cache["state"].float()
    state = (state * decay[..., None, None]
             + torch.einsum("bh,bhp,bn->bhpn", dt1, xin.float(),
                            bmat.float()))
    y = torch.einsum("bhpn,bn->bhp", state, cmat.float())
    y = y + xin.float() * _rank_part(p["d_skip"], tp)[:, None]
    y = y.reshape(b, 1, dl).to(x.dtype)
    y = _gated_norm(y * F.silu(z), _rank_part(p["out_norm"], tp),
                    cfg.norm_eps, tp)
    out = sharding.from_model(torch.matmul(y, p["w_out"]), tp)
    cache["conv"].copy_(window[:, 1:, :])
    cache["state"].copy_(state)
    return x + out, {"conv": cache["conv"], "state": cache["state"]}


def ssm_cache_spec(cfg: ArchConfig, batch: int, dtype: torch.dtype,
                   model_ranks: int = 1) -> Dict[str, ShapeDtype]:
    """The conv window and state of one layer; over ``model_ranks`` a
    rank's: its 1/T of the x channels beside all of B and C, its heads."""
    di, h, hp, n = _dims(cfg)
    t = model_ranks
    return {"conv": ShapeDtype((batch, cfg.ssm_conv - 1, di // t + 2 * n),
                               dtype),
            "state": ShapeDtype((batch, h // t, hp, n), dtype)}
