"""Decoder-only LM over repeating layer patterns (port of
``repro.models.lm``): the dense family (pattern [attn + dense]), the vlm
family's backbone (phi-3-vision), whose frontend stub enters as
precomputed embeddings ahead of the token embeddings, the MoE family
(dense prefix layers + [attn + moe]; deepseek-v2-lite's attention is MLA,
kimi-k2's GQA), the SSM family (pattern [ssm + none], mamba2) and the
hybrid (jamba's pattern of 8: SSM layers with one GQA layer at index 4,
MoE on the odd indices, dense MLPs on the even). Its pattern blocks also
carry the encoder-decoder's cross-attention (``register_pattern_block(...,
cross=True)``, ``apply_pattern_block(..., enc_out=, cross=True)``), which
``models/encdec.EncDecLM`` stacks.

The parameter tree is the reference's: ``embed/tokens``, ``prefix<i>/...``
for unstacked leading layers, ``blocks/l<j>/...`` with a leading
``n_blocks`` axis, ``final_norm`` and, untied, ``lm_head``. The decode
caches are the reference's ``(prefix_caches, block_caches)`` with stacked
leaves, chosen per layer kind: GQA's ``(n_blocks, B, Hkv, S, Dh)``, MLA's
``(n_blocks, B, S, r)``, an SSM layer's conv window ``(n_blocks, B, K−1,
C)`` and state ``(n_blocks, B, H, P, N)`` (no sequence axis). So weights
and caches carry across 1:1 (``convert.py``). The reference's
``jax.lax.scan`` over blocks is a Python loop over the stacked axis.

Modes:
  train_loss(params, batch)    → mean CE + the MoE layers' router aux
  prefill(tokens[, embeds])    → last-position logits + decode caches
  decode_step(token, caches, len) → next logits + caches (updated in place)

``train_loss`` runs under autograd through the plain ``_sdpa``
(``attn_impl="sdpa"``, the reference's ``"xla"``): K2 has no backward, in
either package. The reference's ``jax.checkpoint`` around the scanned
block is ``torch.utils.checkpoint`` around each stacked block, the aux
loss its second output; the aux sums the prefix layers' first, then each
block's, in the reference's order. On parameters sharded over a mesh
(``init_params(generator, mesh, axes)``) each stacked block's leaves are
all-gathered inside that checkpointed function (``models/sharding.py``),
so the recompute gathers them again; the other leaves are gathered once.
Over a model axis of more than one rank every family (and ``EncDecLM``)
trains tensor-parallel (``sharding.tp_of``): GQA, MLA, SwiGLU, the SSM
layer and the expert FFN on the rank's heads, columns or experts, the
token lookup, the logits and the cross-entropy vocab-parallel. Over a
data axis of more than one rank (``sharding.dp_of``) the MoE layers route
each rank's rows with the global microbatch's capacity, slot positions
and aux loss, and a ``loss_mask``'s sums span the data ranks, as on one
device (``models/moe.py``, ``layers.cross_entropy``).

Serving runs over a (1, T) mesh as well: ``prefill`` and ``decode_step``
take the serve tree of ``sharding.for_serve`` and its ``tp``, every layer
on the rank's heads, columns or experts (K2 on the rank's heads in every
GQA prefill), the decode caches the rank's (``decode_cache_specs(...,
model_ranks=T)``: GQA's kv heads, an SSM layer's channels and heads;
MLA's compressed cache whole), and both return the whole ``(B, V_pad)``
logits, made whole over the model group, so every rank reads the same
next token.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.profiler import record_function
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..configs.base import ArchConfig, LayerDesc
from ..device import DeviceLike, resolve_device
from . import attention as attn_mod
from . import moe as moe_mod
from . import sharding
from . import ssm as ssm_mod
from .layers import (ParamSet, ShapeDtype, cross_entropy, hint, rms_norm,
                     swiglu, torch_dtype)


def register_mlp(ps: ParamSet, prefix: str, cfg: ArchConfig,
                 stack: Tuple[int, ...]) -> None:
    d, f = cfg.d_model, cfg.d_ff
    s = tuple(stack)
    ns = (None,) * len(s)
    ps.add(f"{prefix}/w_gate", s + (d, f), ns + ("fsdp", "tp"))
    ps.add(f"{prefix}/w_up", s + (d, f), ns + ("fsdp", "tp"))
    ps.add(f"{prefix}/w_down", s + (f, d), ns + ("tp", "fsdp"))
    ps.add(f"{prefix}/norm", s + (d,), ns + (None,), init="ones")


def mlp_layer(p: Dict, x: torch.Tensor, cfg: ArchConfig,
              tp: Optional[sharding.ModelAxis] = None) -> torch.Tensor:
    return x + swiglu(rms_norm(x, p["norm"], cfg.norm_eps),
                      p["w_gate"], p["w_up"], p["w_down"], tp)


def register_pattern_block(ps: ParamSet, prefix: str, cfg: ArchConfig,
                           pattern: Tuple[LayerDesc, ...],
                           stack: Tuple[int, ...],
                           cross: bool = False) -> None:
    for i, ld in enumerate(pattern):
        pfx = f"{prefix}/l{i}"
        if ld.kind == "attn":
            if cfg.mla:
                attn_mod.register_mla(ps, f"{pfx}/attn", cfg, stack)
            else:
                attn_mod.register_attn(ps, f"{pfx}/attn", cfg, stack)
            if cross:
                attn_mod.register_attn(ps, f"{pfx}/xattn", cfg, stack)
        elif ld.kind == "ssm":
            ssm_mod.register_ssm(ps, f"{pfx}/ssm", cfg, stack)
        else:
            raise ValueError(ld.kind)
        if ld.mlp == "dense":
            register_mlp(ps, f"{pfx}/mlp", cfg, stack)
        elif ld.mlp == "moe":
            moe_mod.register_moe(ps, f"{pfx}/moe", cfg, stack)


def _cross_full(p: Dict, x: torch.Tensor, enc_out: torch.Tensor,
                cfg: ArchConfig, tp: Optional[sharding.ModelAxis] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Cross-attention (no rope, non-causal) against the encoder output,
    through the plain ``_sdpa`` as in the reference. Returns (output,
    {"xk", "xv"} (B, Hkv, S_enc, Dh) for the decode cache). With ``tp``
    on the rank's heads, as ``attention.gqa_full``: the normed decoder
    state and the encoder output go to every model rank (so the encoder's
    gradient is summed over them), ``wq`` / ``wk`` / ``wv`` column blocks,
    ``wo`` a row block whose partial output is summed over the ranks."""
    t = 1 if tp is None else tp.size
    xn = sharding.to_model(rms_norm(x, p["norm"], cfg.norm_eps), tp)
    enc = sharding.to_model(enc_out, tp)
    q = attn_mod._split_heads(torch.matmul(xn, p["wq"]), cfg.n_heads // t)
    k = attn_mod._split_heads(torch.matmul(enc, p["wk"]),
                              cfg.n_kv_heads // t)
    v = attn_mod._split_heads(torch.matmul(enc, p["wv"]),
                              cfg.n_kv_heads // t)
    o = attn_mod._sdpa(q, k, v, causal=False)
    out = sharding.from_model(
        torch.matmul(attn_mod._merge_heads(o), p["wo"]), tp)
    return x + out, {"xk": k, "xv": v}


def _cross_decode(p: Dict, x: torch.Tensor, cache: Dict[str, torch.Tensor],
                  cfg: ArchConfig, tp: Optional[sharding.ModelAxis] = None
                  ) -> torch.Tensor:
    """One-token cross-attention over the cached ``xk`` / ``xv`` (read
    only: every key of the encoder output is visible). With ``tp`` on the
    rank's heads, as :func:`_cross_full`: the cache holds its kv heads,
    ``wo``'s partial output is summed over the model ranks."""
    t = 1 if tp is None else tp.size
    xn = sharding.to_model(rms_norm(x, p["norm"], cfg.norm_eps), tp)
    q = attn_mod._split_heads(torch.matmul(xn, p["wq"]), cfg.n_heads // t)
    o = attn_mod._sdpa(q, cache["xk"], cache["xv"], causal=False)
    return x + sharding.from_model(
        torch.matmul(attn_mod._merge_heads(o), p["wo"]), tp)


def apply_pattern_block(p_block: Dict, x: torch.Tensor, cfg: ArchConfig,
                        pattern: Tuple[LayerDesc, ...], mode: str,
                        caches: Optional[Tuple] = None,
                        cur_len: Optional[int] = None,
                        enc_out: Optional[torch.Tensor] = None,
                        cross: bool = False,
                        causal: bool = True,
                        attn_impl: str = "k2",
                        want_cache: bool = False,
                        tp: Optional[sharding.ModelAxis] = None,
                        dp: Optional[sharding.DataAxis] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, Tuple]:
    """Apply one pattern block. mode: "full" | "decode". Returns (x, the
    summed router aux loss of its MoE layers (() f32), new_caches). MLA
    runs the plain path whatever ``attn_impl`` says, as in the
    reference. With ``cross`` an attention layer is followed by
    cross-attention against ``enc_out`` (full) or the cached ``xk`` /
    ``xv`` (decode), and its cache is ``{k, v, xk, xv}``. Decode writes
    every layer's self-attention and SSM caches in place. ``tp``: GQA,
    MLA, the cross-attention, the SSM, the dense MLP and the MoE layer's
    expert FFN and shared experts on the rank's blocks, in both modes
    (decode on a serve tree, ``sharding.for_serve``). ``dp`` (training
    only): the MoE layers route over the data ranks."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    new_caches: List[Any] = []
    for i, ld in enumerate(pattern):
        lp = p_block[f"l{i}"]
        if ld.kind == "ssm":
            with record_function(f"{mode}/ssm"):
                if mode == "full":
                    x, c = ssm_mod.ssm_full(lp["ssm"], x, cfg, tp)
                else:
                    x, c = ssm_mod.ssm_decode(lp["ssm"], x, caches[i], cfg,
                                              tp)
        else:
            with record_function(f"{mode}/attn"):
                if mode == "full":
                    if cfg.mla:
                        x, c = attn_mod.mla_full(lp["attn"], x, cfg,
                                                 causal=causal, tp=tp)
                    else:
                        x, c = attn_mod.gqa_full(lp["attn"], x, cfg,
                                                 causal=causal,
                                                 attn_impl=attn_impl, tp=tp)
                else:
                    decode = attn_mod.mla_decode if cfg.mla \
                        else attn_mod.gqa_decode
                    x, c = decode(lp["attn"], x, caches[i], cur_len, cfg,
                                  tp)
            if cross:
                with record_function(f"{mode}/xattn"):
                    if mode == "full":
                        x, cx = _cross_full(lp["xattn"], x, enc_out, cfg,
                                            tp)
                    else:
                        x = _cross_decode(lp["xattn"], x, caches[i], cfg,
                                          tp)
                        cx = {"xk": caches[i]["xk"], "xv": caches[i]["xv"]}
                c = {**c, **cx}
        if ld.mlp == "dense":
            with record_function(f"{mode}/mlp"):
                x = mlp_layer(lp["mlp"], x, cfg, tp)
        elif ld.mlp == "moe":
            with record_function(f"{mode}/moe"):
                x, a = moe_mod.moe_layer(lp["moe"], x, cfg, tp, dp)
                aux = aux + a
        if mode == "full" and not want_cache:
            c = ()
        new_caches.append(c)
    return x, aux, tuple(new_caches)


def _index(tree: Any, i: int) -> Any:
    """Slice ``i`` of every leaf's leading axis (views, no copies)."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_index(v, i) for v in tree)
    return tree[i]


def _unbind(tree: Any, n: int) -> List[Any]:
    """The ``n`` slices of every leaf's leading axis, split once per leaf
    with ``torch.unbind``, whose backward is one ``stack``. Under autograd
    ``tree[j]`` (``_index``) would give each of the ``n`` selects a
    backward that writes into a zero tensor the size of the whole leaf."""
    if isinstance(tree, dict):
        parts = {k: _unbind(v, n) for k, v in tree.items()}
        return [{k: parts[k][j] for k in parts} for j in range(n)]
    return list(torch.unbind(tree, 0))


def _stack(trees: List[Any]) -> Any:
    """Stack a list of equal trees along a new leading axis."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_stack([t[j] for t in trees])
                           for j in range(len(first)))
    return torch.stack(trees)


def _map(fn, tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, ShapeDtype):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


# remat="dots": keep what a matmul without batch dims made (the reference's
# dots_with_no_batch_dims_saveable); torch.matmul of (B, S, d) by a weight
# runs aten.mm, the batched attention einsums run bmm and are recomputed
_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(fn, remat: str):
    """``fn`` under the reference's remat policy: ``"none"`` keeps every
    activation, ``"dots"`` saves the outputs of matmuls without batch
    dims, anything else (``"full"``) saves only the block's inputs."""
    if remat == "none":
        return fn
    kw = {}
    if remat == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _save_dots)
    return functools.partial(checkpoint, fn, use_reentrant=False, **kw)


def embed_rows(table: torch.Tensor, tokens: torch.Tensor,
               tp: Optional[sharding.ModelAxis] = None) -> torch.Tensor:
    """``table[tokens]`` through ``F.embedding``: the same rows, and on the
    card a backward that sums each token's gradient rows in f32 before one
    rounding into a bf16 table's gradient. Advanced indexing's backward
    (``index_put_``) rounds after every row, so a frequent token loses its
    small addends, and the more rows a card sums the more it loses: the
    gradient would change with the number of ranks.

    With ``tp`` the table is the rank's vocab block ``[rank·V, (rank+1)·V)``:
    each rank looks up the tokens in its range, zeros the others' rows,
    and the rows are summed over the model ranks (one nonzero term each,
    so the sum is the lookup's row exactly)."""
    if tp is None:
        return F.embedding(tokens, table)
    v = table.shape[0]
    row = tokens.long() - tp.rank * v
    mine = (row >= 0) & (row < v)
    out = F.embedding(torch.where(mine, row, 0), table)
    out = torch.where(mine[..., None], out,
                      torch.zeros((), dtype=out.dtype, device=out.device))
    return sharding.from_model(out, tp)


def mask_vocab(logits: torch.Tensor, vocab_size: int,
               tp: Optional[sharding.ModelAxis] = None) -> torch.Tensor:
    """Logits over the padded vocab with the padded columns (at or past
    ``vocab_size``) at -1e30; with ``tp`` the logits are this rank's vocab
    block, its columns starting at ``rank·V``."""
    v = logits.shape[-1]
    col = torch.arange(v, device=logits.device) + (
        0 if tp is None else tp.rank * v)
    return torch.where(col < vocab_size, logits,
                       torch.full((), -1e30, dtype=logits.dtype,
                                  device=logits.device))


def whole_logits(logits: torch.Tensor,
                 tp: Optional[sharding.ModelAxis]) -> torch.Tensor:
    """Logits over the whole padded vocab: with ``tp`` the model ranks'
    vocab blocks all-gathered along the last dim, the same bytes on every
    rank (so a greedy token taken from them is every rank's); themselves
    without ``tp``."""
    if tp is None:
        return logits
    return sharding.join_model(logits, logits.dim() - 1, tp)


def _train_block(x: torch.Tensor, p_block: Dict, cfg: ArchConfig,
                 pattern: Tuple[LayerDesc, ...], attn_impl: str,
                 plan: Any = None,
                 tp: Optional[sharding.ModelAxis] = None,
                 dp: Optional[sharding.DataAxis] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x, the block's summed router aux loss). With a ``plan`` the
    block's leaves are this rank's blocks, gathered here over the data
    axis; with ``tp`` the layers are tensor-parallel over the model axis;
    with ``dp`` the MoE layers route over the data ranks (the recompute
    under remat issues its collectives again)."""
    return apply_pattern_block(sharding.gather(p_block, plan), x, cfg,
                               pattern, "full", attn_impl=attn_impl,
                               tp=tp, dp=dp)[:2]


class LM:
    """Decoder-only language model, dense, vlm, MoE, SSM and hybrid
    families (pattern-stacked).

    ``device`` (None → the CUDA card, raising without one) is where
    :meth:`init_params` and :meth:`init_decode_caches` put their tensors;
    ``attn_impl`` is ``"k2"`` (the reference's ``"pallas"``) or ``"sdpa"``
    (its ``"xla"``).
    """

    def __init__(self, cfg: ArchConfig, attn_impl: str = "k2",
                 device: DeviceLike = None):
        if attn_impl not in attn_mod.ATTN_IMPLS:
            raise ValueError(f"attn_impl must be one of "
                             f"{attn_mod.ATTN_IMPLS}, got {attn_impl!r}")
        self.cfg = cfg
        self.attn_impl = attn_impl
        self.device = resolve_device(device)
        self.pattern = cfg.layer_pattern()
        self.n_prefix = cfg.first_dense_layers
        n_scanned = cfg.n_layers - self.n_prefix
        assert n_scanned % len(self.pattern) == 0, cfg.name
        self.n_blocks = n_scanned // len(self.pattern)
        self.pdt = torch_dtype(cfg.param_dtype)
        self.adt = torch_dtype(cfg.activation_dtype)

        # vocab padded to a 128 multiple (the reference shards the table on
        # any TP degree); padded logit columns are masked in _logits
        self.v_pad = ((cfg.vocab_size + 127) // 128) * 128
        ps = ParamSet(dtype=self.pdt)
        ps.add("embed/tokens", (self.v_pad, cfg.d_model), ("tp", "fsdp"))
        prefix_pat = (LayerDesc(kind="attn", mlp="dense"),)
        for i in range(self.n_prefix):
            register_pattern_block(ps, f"prefix{i}", cfg, prefix_pat, ())
        register_pattern_block(ps, "blocks", cfg, self.pattern,
                               (self.n_blocks,))
        ps.add("final_norm", (cfg.d_model,), (None,), init="ones")
        if not cfg.tie_embeddings:
            ps.add("lm_head", (cfg.d_model, self.v_pad), ("fsdp", "tp"))
        self.ps = ps
        self.prefix_pattern = prefix_pat

    # -- parameter plumbing --------------------------------------------------
    def init_params(self, generator: torch.Generator, mesh=None,
                    axes=None) -> Dict:
        """Random-init weights from ``generator``, which must live on the
        model's device; with a ``DeviceMesh``, each rank's block of every
        leaf (``ParamSet.init_params``). A model axis of more than one
        rank raises ValueError where the heads, kv heads, ``d_ff``, the
        padded vocab, the SSM's heads, ``w_in`` columns or conv channels,
        or the experts or their FFN dims do not divide over it
        (``launch/mesh.check_divides``)."""
        if generator.device.type != self.device.type:
            raise ValueError(f"generator is on {generator.device}, the model "
                             f"on {self.device}")
        if mesh is not None:
            from ..launch.mesh import check_divides
            if sharding.model_ranks(mesh) > 1:
                check_divides(self.cfg, mesh)
        return self.ps.init_params(generator, mesh, axes)

    def n_params(self) -> int:
        return self.ps.n_params()

    # -- embedding / head ----------------------------------------------------
    def _embed(self, params: Dict, tokens: torch.Tensor,
               frontend_embeds: Optional[torch.Tensor],
               tp: Optional[sharding.ModelAxis] = None) -> torch.Tensor:
        x = embed_rows(params["embed"]["tokens"], tokens, tp).to(self.adt)
        if frontend_embeds is not None:
            x = torch.cat([frontend_embeds.to(self.adt), x], dim=1)
        return hint(x, "batch", None, None)

    def _logits(self, params: Dict, x: torch.Tensor,
                tp: Optional[sharding.ModelAxis] = None) -> torch.Tensor:
        """Logits over the padded vocab, its padded columns masked; with
        ``tp`` this rank's vocab block of them (the head's, or the tied
        table's, columns ``[rank·V, (rank+1)·V)``)."""
        x = sharding.to_model(
            rms_norm(x, params["final_norm"], self.cfg.norm_eps), tp)
        if self.cfg.tie_embeddings:
            logits = torch.matmul(x, params["embed"]["tokens"].T)
        else:
            logits = torch.matmul(x, params["lm_head"])
        if self.v_pad != self.cfg.vocab_size:
            logits = mask_vocab(logits, self.cfg.vocab_size, tp)
        return hint(logits, "batch", None, "tp")

    # -- full-sequence pass ----------------------------------------------------
    def _run_blocks_full(self, params: Dict, x: torch.Tensor,
                         want_cache: bool,
                         tp: Optional[sharding.ModelAxis] = None
                         ) -> Tuple[torch.Tensor, List, Tuple]:
        cfg = self.cfg
        prefix_caches = []
        for i in range(self.n_prefix):
            x, _, c = apply_pattern_block(
                params[f"prefix{i}"], x, cfg, self.prefix_pattern, "full",
                attn_impl=self.attn_impl, want_cache=want_cache, tp=tp)
            prefix_caches.append(c)
        per_block = []
        for j in range(self.n_blocks):
            x, _, c = apply_pattern_block(
                _index(params["blocks"], j), x, cfg, self.pattern, "full",
                attn_impl=self.attn_impl, want_cache=want_cache, tp=tp)
            per_block.append(c)
        return x, prefix_caches, _stack(per_block)

    def _run_blocks_train(self, params: Dict, x: torch.Tensor,
                          plan: Any = None,
                          tp: Optional[sharding.ModelAxis] = None,
                          dp: Optional[sharding.DataAxis] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The full pass under autograd: prefix layers as they are, each
        stacked block under ``cfg.remat`` on its slice of the stacked
        leaves (split once, :func:`_unbind`; with a ``plan``, gathered
        inside the block; with ``tp``, tensor-parallel; with ``dp``, MoE
        routed over the data ranks). Returns (x, the
        summed router aux loss () f32: the prefix layers', then each
        block's)."""
        cfg = self.cfg
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        for i in range(self.n_prefix):
            x, aux, _ = apply_pattern_block(
                params[f"prefix{i}"], x, cfg, self.prefix_pattern, "full",
                attn_impl=self.attn_impl, tp=tp, dp=dp)
            aux_total = aux_total + aux
        block = _remat(functools.partial(
            _train_block, cfg=cfg, pattern=self.pattern,
            attn_impl=self.attn_impl, plan=plan, tp=tp, dp=dp), cfg.remat)
        for p_block in _unbind(params["blocks"], self.n_blocks):
            x, aux = block(x, p_block)
            aux_total = aux_total + aux
        return x, aux_total

    # -- public entry points ---------------------------------------------------
    def train_loss(self, params: Dict, batch: Dict[str, torch.Tensor]
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Mean next-token CE + the MoE layers' router aux loss (zero
        without experts) of a batch ``{"tokens", "labels"[,
        "frontend_embeds"][, "loss_mask"]}``: logits after the frontend
        positions, ``[:, :-1]`` against ``labels[:, 1:]``. Returns
        ``(loss, {"ce", "aux"})``. On a mesh whose data axis has more than
        one rank the batch is this rank's rows (``data.rank_batch_at``),
        the aux loss and a masked CE are the global microbatch's, the same
        on every rank, and an unmasked CE is the mean over its rows."""
        if self.attn_impl == "k2":
            raise ValueError(
                "train_loss: K2 has no backward (nor has the reference's "
                "Pallas kernel); training runs attn_impl='sdpa'")
        tp, dp = sharding.tp_of(params), sharding.dp_of(params)
        params, plans = sharding.for_train(params, ("blocks",))
        fe = batch.get("frontend_embeds")
        x = self._embed(params, batch["tokens"], fe, tp)
        x, aux = self._run_blocks_train(params, x, plans.get("blocks"), tp,
                                        dp)
        with record_function("train/logits_ce"):
            logits = self._logits(params, x, tp)
            nfe = 0 if fe is None else fe.shape[1]
            ce = cross_entropy(logits[:, nfe:][:, :-1],
                               batch["labels"][:, 1:],
                               batch.get("loss_mask"), tp, dp)
        return ce + aux, {"ce": ce, "aux": aux}

    @torch.no_grad()
    def prefill(self, params: Dict, tokens: torch.Tensor,
                frontend_embeds: Optional[torch.Tensor] = None,
                tp: Optional[sharding.ModelAxis] = None
                ) -> Tuple[torch.Tensor, Tuple[List, Tuple]]:
        """tokens: (B, S) int. Returns (logits (B, V_pad) at the last
        position, (prefix_caches, block_caches)) with caches S long. With
        ``tp`` (a serve tree, ``sharding.for_serve``) every layer runs on
        the rank's blocks, the caches are the rank's, and the logits are
        made whole over the model group."""
        x = self._embed(params, tokens, frontend_embeds, tp)
        x, prefix_caches, caches = self._run_blocks_full(
            params, x, want_cache=True, tp=tp)
        with record_function("full/logits"):
            logits = whole_logits(self._logits(params, x[:, -1:, :], tp),
                                  tp)
        return logits[:, 0], (prefix_caches, caches)

    @torch.no_grad()
    def decode_step(self, params: Dict, token: torch.Tensor,
                    caches: Tuple[List, Tuple], cur_len: int,
                    tp: Optional[sharding.ModelAxis] = None
                    ) -> Tuple[torch.Tensor, Tuple[List, Tuple]]:
        """token: (B,) int; cur_len: the position being written, one for the
        whole batch. The caches are written in place and returned. With
        ``tp`` as :meth:`prefill`: the caches the rank's, the logits whole
        on every rank."""
        cfg = self.cfg
        cur_len = int(cur_len)
        prefix_caches, block_caches = caches
        x = embed_rows(params["embed"]["tokens"], token[:, None],
                       tp).to(self.adt)
        for i in range(self.n_prefix):
            x, _, _ = apply_pattern_block(
                params[f"prefix{i}"], x, cfg, self.prefix_pattern, "decode",
                caches=prefix_caches[i], cur_len=cur_len, tp=tp)
        for j in range(self.n_blocks):
            x, _, _ = apply_pattern_block(
                _index(params["blocks"], j), x, cfg, self.pattern, "decode",
                caches=_index(block_caches, j), cur_len=cur_len, tp=tp)
        with record_function("decode/logits"):
            logits = whole_logits(self._logits(params, x, tp), tp)
        return logits[:, 0], caches

    # -- cache construction ------------------------------------------------------
    def _slot_cache_spec(self, ld: LayerDesc, batch: int, s_max: int,
                         stack: Tuple[int, ...], model_ranks: int = 1
                         ) -> Dict[str, ShapeDtype]:
        if ld.kind == "ssm":
            spec = ssm_mod.ssm_cache_spec(self.cfg, batch, self.adt,
                                          model_ranks)
        elif self.cfg.mla:
            spec = attn_mod.mla_cache_spec(self.cfg, batch, s_max, self.adt)
        else:
            spec = attn_mod.gqa_cache_spec(self.cfg, batch, s_max, self.adt,
                                           model_ranks)
        return {k: ShapeDtype(stack + sd.shape, sd.dtype)
                for k, sd in spec.items()}

    def decode_cache_specs(self, batch: int, s_max: int,
                           model_ranks: int = 1) -> Tuple[List, Tuple]:
        """The decode caches' shapes; over a model axis of ``model_ranks``
        one rank's (GQA's kv heads and an SSM layer's channels and heads
        split, MLA's cache whole)."""
        prefix = [tuple(self._slot_cache_spec(ld, batch, s_max, (),
                                              model_ranks)
                        for ld in self.prefix_pattern)
                  for _ in range(self.n_prefix)]
        blocks = tuple(self._slot_cache_spec(ld, batch, s_max,
                                             (self.n_blocks,), model_ranks)
                       for ld in self.pattern)
        return prefix, blocks

    def init_decode_caches(self, batch: int, s_max: int,
                           model_ranks: int = 1) -> Tuple[List, Tuple]:
        """Zero decode caches on the model's device (a rank's over a model
        axis of ``model_ranks``)."""
        return _map(lambda sd: torch.zeros(sd.shape, dtype=sd.dtype,
                                           device=self.device),
                    self.decode_cache_specs(batch, s_max, model_ranks))
