"""Mixture-of-Experts with capacity-bounded dispatch (port of
``repro.models.moe``).

Each token picks its ``top_k`` experts by router probability; its position
in each expert's buffer is a prefix sum over the flattened (T·k) token →
expert assignments, and assignments past the expert's ``capacity`` are
dropped (GShard semantics; the residual path carries them). Two dispatches
give the same buffers: ``"scatter"`` writes each kept row into an
``(E, cap + 1, D)`` buffer whose last slot parks the dropped ones,
``"gather"`` scatters token ids and gathers rows once. The expert FFN is
one batched matmul per weight over all E experts' buffers.

Kept from the reference:
  * the router logits are rounded to the activation dtype before the f32
    softmax;
  * ties among the top-k probabilities go to the lower expert index, as
    ``jax.lax.top_k`` orders them (:func:`top_k`);
  * the capacity depends on the token count, so a long prefill may drop
    assignments where a decode step of a few tokens never does;
  * the combine casts each gate to the activation dtype before it weights
    the expert's row, and sums the k rows in that dtype.

The reference's sharding ``hint``s stand where it has them, on the
expert buffers and the expert FFN's outputs over ``expert_axes``; they are
identities on plain tensors (``layers.hint``).

In training over a model axis of T ranks (``tp``, ``models/sharding.py``)
every model rank computes the router, the slot positions, the aux loss
and the combine on the same tokens; only the expert FFN is split, as
``expert_axes`` lays its weights out. With the FFN dim over "tp" the
rank holds every expert's (D, F/T) columns of ``w_gate`` / ``w_up`` and
(F/T, D) rows of ``w_down``: the buffer enters through
``sharding.to_model`` and the experts' partial outputs are summed by
``sharding.from_model``. With the experts over "tp" the rank runs its
E/T experts on its slice of the buffer (taken after ``to_model``) and
``sharding.join_model`` makes their outputs whole, so the combine sums
each token's k rows in the activation dtype as on one device. With
neither (``moe_ffn_unsharded``, experts over "fsdp") the expert FFN runs
whole on every rank. The shared experts are a Megatron SwiGLU.

In training over a data axis of W ranks (``dp``) each rank routes its own
t tokens, a block of the global microbatch's W·t, with the reference's
global meaning (:func:`global_slots`): the capacity is that of W·t
tokens; an assignment's position is the count of the lower data ranks'
assignments to its expert plus its local exclusive prefix sum, kept while
below the capacity; the aux loss's ``f_e`` and ``p_e`` are means over
the W·t tokens. The rank's ``(E, cap, D)`` buffer holds only its own kept
rows, each at its global position less the rank's offset, and the expert
FFN works row by row, so every kept token gets the one-device value. The
table of counts is all-gathered once (no gradient), the summed router
probabilities all-reduced forward and backward
(``sharding.sum_over_data``); the recompute under remat issues both
again, in the same order on every rank. Every model rank of a data row
routes the same tokens, as above.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from . import sharding
from .layers import ParamSet, hint, rms_norm, swiglu


def expert_axes(cfg: ArchConfig) -> Tuple[str, Optional[str]]:
    """(expert-dim axis, ffn-dim axis) of the reference's 2D expert
    sharding: experts over "fsdp" when 32 divides their count, else over
    "tp" with the FFN dim over "fsdp"; ``moe_ffn_unsharded`` leaves the FFN
    dim whole."""
    if cfg.moe_ffn_unsharded:
        return ("fsdp" if cfg.n_experts % 32 == 0 else "tp"), None
    if cfg.n_experts % 32 == 0:
        return "fsdp", "tp"
    return "tp", "fsdp"


def register_moe(ps: ParamSet, prefix: str, cfg: ArchConfig,
                 stack: Tuple[int, ...]) -> None:
    d, e, f = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    e_ax, f_ax = expert_axes(cfg)
    s = tuple(stack)
    ns = (None,) * len(s)
    ps.add(f"{prefix}/router", s + (d, e), ns + ("fsdp", None), std=0.006)
    ps.add(f"{prefix}/w_gate", s + (e, d, f), ns + (e_ax, None, f_ax))
    ps.add(f"{prefix}/w_up", s + (e, d, f), ns + (e_ax, None, f_ax))
    ps.add(f"{prefix}/w_down", s + (e, f, d), ns + (e_ax, f_ax, None))
    if cfg.n_shared_experts:
        fs = cfg.moe_d_ff * cfg.n_shared_experts
        ps.add(f"{prefix}/ws_gate", s + (d, fs), ns + ("fsdp", "tp"))
        ps.add(f"{prefix}/ws_up", s + (d, fs), ns + ("fsdp", "tp"))
        ps.add(f"{prefix}/ws_down", s + (fs, d), ns + ("tp", "fsdp"))
    ps.add(f"{prefix}/norm", s + (d,), ns + (None,), init="ones")


def capacity(tokens: int, cfg: ArchConfig) -> int:
    """Slots per expert for ``tokens`` tokens: ceil(T·k·factor / E), at
    least 8 and padded to a multiple of 8."""
    c = math.ceil(tokens * cfg.top_k * cfg.capacity_factor / cfg.n_experts)
    return max(8, ((c + 7) // 8) * 8)


def top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest values along the last axis, largest first, with
    ties in ascending index order as ``jax.lax.top_k`` gives them
    (``torch.topk`` orders ties arbitrarily): a stable descending sort."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(xt: torch.Tensor, router: torch.Tensor, cfg: ArchConfig
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Router of tokens ``xt`` (T, D): (renormalised gates (T, k) f32,
    expert indices (T, k), probabilities (T, E) f32)."""
    logits = torch.matmul(xt, router).float()
    probs = torch.softmax(logits, dim=-1)
    gate, expert_idx = top_k(probs, cfg.top_k)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    return gate, expert_idx, probs


def positions(expert_idx: torch.Tensor, n_experts: int, cap: int,
              offset: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Slot reservation over the flattened (T·k) assignments: (expert of
    each assignment, its position in that expert's buffer, kept: position
    < ``cap``). The position counts the earlier assignments to the same
    expert (an exclusive prefix sum). With ``offset`` (E,), the lower data
    ranks' assignments to each expert, an assignment is kept while its
    global position, ``offset[e]`` more, is below ``cap``; the position
    returned is still the one in this rank's buffer. The one-hot is laid
    out (E, T·k) so the sum scans its rows' inner axis: CUDA's scan along
    the outer axis of a (T·k, E) one-hot runs one thread a column (2 ms at
    10,686 × 64)."""
    flat_e = expert_idx.reshape(-1)
    experts = torch.arange(n_experts, device=flat_e.device)
    onehot = (flat_e[None, :] == experts[:, None]).long()        # (E, T·k)
    before = torch.cumsum(onehot, dim=1) - onehot
    pos = torch.gather(before, 0, flat_e[None, :])[0]
    glob = pos if offset is None else pos + offset[flat_e]
    return flat_e, pos, glob < cap


def global_slots(expert_idx: torch.Tensor, tokens: int, cfg: ArchConfig,
                 dp: sharding.DataAxis
                 ) -> Tuple[int, torch.Tensor, torch.Tensor]:
    """Routing over the data ranks, from this rank's expert indices
    ``(tokens, k)``: (the capacity of the global microbatch's
    ``dp.size · tokens`` tokens, this rank's slot offset per expert (E,)
    int64: the assignments of the lower data ranks, the aux loss's
    ``f_e`` (E,) f32: the global share of top-1 choices). Each rank's
    assignments and top-1 choices per expert go in one all-gather of a
    (2E,) int64 row."""
    e = cfg.n_experts
    experts = torch.arange(e, device=expert_idx.device)[:, None]
    counts = torch.cat([(expert_idx.reshape(-1)[None, :] == experts).sum(1),
                        (expert_idx[None, :, 0] == experts).sum(1)])
    table = sharding.gather_data(counts.long(), dp)              # (W, 2E)
    offset = table[:dp.rank, :e].sum(0)
    fe = table[:, e:].sum(0).float() / (dp.size * tokens)
    return capacity(dp.size * tokens, cfg), offset, fe


def moe_layer(p: Dict, x: torch.Tensor, cfg: ArchConfig,
              tp: Optional[sharding.ModelAxis] = None,
              dp: Optional[sharding.DataAxis] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D). Returns (x + MoE output, router aux loss () f32).
    With ``tp`` the expert FFN and the shared experts run on the rank's
    blocks; with ``dp`` x is this data rank's block of the global
    microbatch, routed with the global capacity, positions and aux loss
    (module docstring)."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    xn = rms_norm(x, p["norm"], cfg.norm_eps)
    xt = xn.reshape(b * s, d)
    t = b * s
    gate, expert_idx, probs = route(xt, p["router"], cfg)

    # load-balancing aux loss (Switch/GShard): E · sum_e f_e · p_e
    if dp is None:
        cap, offset = capacity(t, cfg), None
        me = probs.mean(dim=0)
        fe = F.one_hot(expert_idx[:, 0], e).float().mean(dim=0)
    else:
        cap, offset, fe = global_slots(expert_idx, t, cfg, dp)
        me = sharding.sum_over_data(probs.sum(dim=0), dp) / (dp.size * t)
    aux = e * torch.sum(fe * me) * cfg.router_aux_coef

    flat_e, pos, keep = positions(expert_idx, e, cap, offset)
    pos_c = torch.where(keep, pos, torch.full_like(pos, cap))     # parked
    e_ax, f_ax = expert_axes(cfg)
    if cfg.moe_dispatch == "gather":
        token_ids = torch.arange(t, device=x.device)[:, None].expand(
            t, k).reshape(-1)
        slot_tok = torch.zeros((e, cap + 1), dtype=torch.int64,
                               device=x.device)
        slot_tok.index_put_((flat_e, pos_c), token_ids)
        slot_ok = torch.zeros((e, cap + 1), dtype=torch.bool,
                              device=x.device)
        slot_ok.index_put_((flat_e, pos_c), keep)
        buf = xt[slot_tok[:, :cap]] * slot_ok[:, :cap, None].to(xt.dtype)
        buf = hint(buf, e_ax, None, None)
    else:
        # each kept (expert, position) slot receives exactly one row, so a
        # plain write equals the reference's scatter-add there; the rows
        # parked in slot ``cap`` (written in any order) are cut off
        buf = torch.zeros((e, cap + 1, d), dtype=xt.dtype, device=x.device)
        buf.index_put_((flat_e.view(t, k), pos_c.view(t, k)), xt[:, None])
        buf = hint(buf[:, :cap], e_ax, None, None)

    split = tp is not None and "tp" in (e_ax, f_ax)
    if split:
        # the buffer's gradient from the rank's FFN columns or experts is
        # a part of the whole
        buf = sharding.to_model(buf, tp)
        if e_ax == "tp":
            n = e // tp.size
            buf = buf[tp.rank * n:(tp.rank + 1) * n]
    h = hint(torch.matmul(buf, p["w_gate"]), e_ax, None, f_ax)   # (E,cap,F)
    u = hint(torch.matmul(buf, p["w_up"]), e_ax, None, f_ax)
    out_e = torch.matmul(F.silu(h) * u, p["w_down"])             # (E,cap,D)
    if split:
        out_e = (sharding.join_model(out_e, 0, tp) if e_ax == "tp"
                 else sharding.from_model(out_e, tp))
    out_e = hint(out_e, e_ax, None, None)

    # combine: gather back, weight by the gate cast to the activation dtype
    gathered = out_e[flat_e, torch.clamp(pos_c, max=cap - 1)]     # (T·k, D)
    gathered = gathered * (keep[:, None] * gate.reshape(-1)[:, None]
                           ).to(xt.dtype)
    y = gathered.reshape(t, k, d).sum(dim=1)

    if cfg.n_shared_experts:
        y = y + swiglu(xt, p["ws_gate"], p["ws_up"], p["ws_down"], tp)
    return x + y.reshape(b, s, d), aux
