"""Encoder-decoder backbone (seamless-m4t): audio-frame encoder + text
decoder (port of ``repro.models.encdec``).

The audio frontend is a stub, as in the reference: the caller passes
precomputed frame embeddings (B, S_enc, d_model); the encoder is a
non-causal stack over them, with rope at ``arange(S_enc)``. The decoder is
a causal stack whose layers add cross-attention (no rope, non-causal, the
plain ``_sdpa``) against the encoder output; its K/V are cached at prefill
as ``xk`` / ``xv`` (decode never re-encodes). The frames do not offset the
decoder's positions.

The parameter tree is the reference's: ``embed/tokens``, ``enc_blocks``
stacked ``(encoder_layers,)``, ``enc_norm``, ``dec_blocks`` stacked
``(n_layers,)`` with ``xattn`` beside ``attn``, ``final_norm``,
``lm_head``. The decode caches are ``([], ({k, v, xk, xv},))`` with
leaves ``(n_layers, B, Hkv, S, Dh)`` (``S`` = ``s_max`` for ``k`` / ``v``,
``s_enc`` for ``xk`` / ``xv``), so weights and caches carry across 1:1
(``convert.py``). The reference's ``jax.lax.scan`` over layers is a Python
loop over the stacked axis; its ``jax.checkpoint`` around both stacks is
``torch.utils.checkpoint`` around each layer (``lm._remat`` with
``"full"``: the reference applies no ``dots`` policy here). On parameters
sharded over a mesh each layer's leaves of both stacks are all-gathered
inside that function (``models/sharding.py``), the other leaves once.
Over a model axis of more than one rank (``sharding.tp_of``) every layer
of both stacks is tensor-parallel (GQA, the cross-attention and SwiGLU
on the rank's heads and columns), the token lookup, the logits and the
cross-entropy vocab-parallel; ``enc_norm`` and ``final_norm`` stay
whole on every rank. Serving takes the serve tree of
``sharding.for_serve`` and its ``tp`` the same way: both stacks on the
rank's heads (K2 on them in every encoder and decoder self-attention),
the decode caches the rank's kv heads (``xk`` / ``xv`` too), the logits
made whole over the model group.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.profiler import record_function

from ..configs.base import ArchConfig, LayerDesc
from ..device import DeviceLike, resolve_device
from . import attention as attn_mod
from . import sharding
from .layers import ParamSet, ShapeDtype, cross_entropy, rms_norm, torch_dtype
from .lm import (_index, _map, _remat, _stack, _unbind, apply_pattern_block,
                 embed_rows, mask_vocab, register_pattern_block,
                 whole_logits)


def _enc_layer(x: torch.Tensor, p_block: Dict, cfg: ArchConfig,
               pattern: Tuple[LayerDesc, ...], attn_impl: str,
               plan: Any = None,
               tp: Optional[sharding.ModelAxis] = None) -> torch.Tensor:
    return apply_pattern_block(sharding.gather(p_block, plan), x, cfg,
                               pattern, "full", causal=False,
                               attn_impl=attn_impl, tp=tp)[0]


def _dec_layer(x: torch.Tensor, enc_out: torch.Tensor, p_block: Dict,
               cfg: ArchConfig, pattern: Tuple[LayerDesc, ...],
               attn_impl: str, plan: Any = None,
               tp: Optional[sharding.ModelAxis] = None) -> torch.Tensor:
    return apply_pattern_block(sharding.gather(p_block, plan), x, cfg,
                               pattern, "full", enc_out=enc_out, cross=True,
                               attn_impl=attn_impl, tp=tp)[0]


class EncDecLM:
    """Encoder-decoder model (seamless-m4t-large-v2's family).

    ``device`` (None → the CUDA card, raising without one) is where
    :meth:`init_params` and :meth:`init_decode_caches` put their tensors;
    ``attn_impl`` is ``"k2"`` (the reference's ``"pallas"``: K2 on every
    encoder and decoder self-attention, non-causal in the encoder) or
    ``"sdpa"`` (its ``"xla"``, for training: K2 has no backward).
    """

    def __init__(self, cfg: ArchConfig, attn_impl: str = "k2",
                 device: DeviceLike = None):
        assert cfg.encoder_layers > 0
        if attn_impl not in attn_mod.ATTN_IMPLS:
            raise ValueError(f"attn_impl must be one of "
                             f"{attn_mod.ATTN_IMPLS}, got {attn_impl!r}")
        self.cfg = cfg
        self.attn_impl = attn_impl
        self.device = resolve_device(device)
        self.pdt = torch_dtype(cfg.param_dtype)
        self.adt = torch_dtype(cfg.activation_dtype)
        self.pat = (LayerDesc(kind="attn", mlp="dense"),)

        self.v_pad = ((cfg.vocab_size + 127) // 128) * 128
        ps = ParamSet(dtype=self.pdt)
        ps.add("embed/tokens", (self.v_pad, cfg.d_model), ("tp", "fsdp"))
        register_pattern_block(ps, "enc_blocks", cfg, self.pat,
                               (cfg.encoder_layers,))
        ps.add("enc_norm", (cfg.d_model,), (None,), init="ones")
        register_pattern_block(ps, "dec_blocks", cfg, self.pat,
                               (cfg.n_layers,), cross=True)
        ps.add("final_norm", (cfg.d_model,), (None,), init="ones")
        ps.add("lm_head", (cfg.d_model, self.v_pad), ("fsdp", "tp"))
        self.ps = ps

    def init_params(self, generator: torch.Generator, mesh=None,
                    axes=None) -> Dict:
        """Random-init weights from ``generator``, which must live on the
        model's device; with a ``DeviceMesh``, each rank's block of every
        leaf (``ParamSet.init_params``). Over a model axis of more than
        one rank both stacks train tensor-parallel: ValueError where the
        heads, kv heads, ``d_ff`` or the padded vocab do not divide over it
        (``launch/mesh.check_divides``), as ``LM`` raises."""
        if generator.device.type != self.device.type:
            raise ValueError(f"generator is on {generator.device}, the model "
                             f"on {self.device}")
        if mesh is not None and sharding.model_ranks(mesh) > 1:
            from ..launch.mesh import check_divides
            check_divides(self.cfg, mesh)
        return self.ps.init_params(generator, mesh, axes)

    def n_params(self) -> int:
        return self.ps.n_params()

    def _layer(self, fn, plan: Any = None,
               tp: Optional[sharding.ModelAxis] = None):
        """``fn`` under the reference's ``jax.checkpoint`` when it runs under
        autograd and the config remats; as it is otherwise. With a
        ``plan`` each call gathers its layer's leaves first; with ``tp``
        the layer is tensor-parallel."""
        fn = functools.partial(fn, cfg=self.cfg, pattern=self.pat,
                               attn_impl=self.attn_impl, plan=plan, tp=tp)
        if not torch.is_grad_enabled() or self.cfg.remat == "none":
            return fn
        return _remat(fn, "full")

    def _logits(self, params: Dict, x: torch.Tensor,
                tp: Optional[sharding.ModelAxis] = None) -> torch.Tensor:
        """Logits over the padded vocab, its padded columns masked; with
        ``tp`` this rank's vocab block of them (``lm_head``'s columns
        ``[rank·V, (rank+1)·V)``)."""
        x = sharding.to_model(
            rms_norm(x, params["final_norm"], self.cfg.norm_eps), tp)
        logits = torch.matmul(x, params["lm_head"])
        if self.v_pad != self.cfg.vocab_size:
            logits = mask_vocab(logits, self.cfg.vocab_size, tp)
        return logits

    # -- encoder -------------------------------------------------------------
    def encode(self, params: Dict, frames: torch.Tensor,
               plan: Any = None,
               tp: Optional[sharding.ModelAxis] = None) -> torch.Tensor:
        """frames (B, S_enc, d_model), any float dtype (cast to the
        activation dtype first). Returns the normalised encoder output.
        ``plan``: the layouts of one encoder layer's blocks
        (``sharding.for_train``); ``tp``: the layers tensor-parallel (the
        output is whole on every model rank)."""
        cfg = self.cfg
        with record_function("encode"):
            x = frames.to(self.adt)
            layer = self._layer(_enc_layer, plan, tp)
            for p_block in _unbind(params["enc_blocks"], cfg.encoder_layers):
                x = layer(x, p_block)
            return rms_norm(x, params["enc_norm"], cfg.norm_eps)

    # -- decoder -------------------------------------------------------------
    def _decode_full(self, params: Dict, tokens: torch.Tensor,
                     enc_out: torch.Tensor, want_cache: bool,
                     last_only: bool = False, plan: Any = None,
                     tp: Optional[sharding.ModelAxis] = None
                     ) -> Tuple[torch.Tensor, Tuple]:
        """The decoder over ``tokens`` (B, S) against ``enc_out``: logits
        (B, S, V_pad), or (B, 1, V_pad) at the last position with
        ``last_only``, and with ``want_cache`` the stacked layer caches
        ``({k, v, xk, xv},)``, else ``()``. With ``tp`` the layers are
        tensor-parallel and the lookup and logits vocab-parallel: the
        logits are this rank's vocab block, the caches its kv heads."""
        cfg = self.cfg
        x = embed_rows(params["embed"]["tokens"], tokens, tp).to(self.adt)
        layers = _unbind(params["dec_blocks"], cfg.n_layers)
        caches: Tuple = ()
        if want_cache:
            per_layer = []
            for p_block in layers:
                x, _, c = apply_pattern_block(
                    p_block, x, cfg, self.pat, "full", enc_out=enc_out,
                    cross=True, attn_impl=self.attn_impl, want_cache=True,
                    tp=tp)
                per_layer.append(c)
            caches = _stack(per_layer)
        else:
            layer = self._layer(_dec_layer, plan, tp)
            for p_block in layers:
                x = layer(x, enc_out, p_block)
        if last_only:
            x = x[:, -1:, :]
        with record_function("full/logits"):
            return self._logits(params, x, tp), caches

    # -- public API ----------------------------------------------------------
    def train_loss(self, params: Dict, batch: Dict[str, torch.Tensor]
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Mean next-token CE of a batch ``{"tokens", "labels",
        "frontend_embeds"[, "loss_mask"]}``: the frames through the
        encoder, the tokens through the decoder, ``logits[:, :-1]`` against
        ``labels[:, 1:]``. Returns ``(ce, {"ce", "aux"})``, aux 0. A
        masked CE spans the data ranks (``layers.cross_entropy``)."""
        if self.attn_impl == "k2":
            raise ValueError(
                "train_loss: K2 has no backward (nor has the reference's "
                "Pallas kernel); training runs attn_impl='sdpa'")
        tp, dp = sharding.tp_of(params), sharding.dp_of(params)
        params, plans = sharding.for_train(params,
                                           ("enc_blocks", "dec_blocks"))
        enc_out = self.encode(params, batch["frontend_embeds"],
                              plans.get("enc_blocks"), tp)
        logits, _ = self._decode_full(params, batch["tokens"], enc_out,
                                      want_cache=False,
                                      plan=plans.get("dec_blocks"), tp=tp)
        with record_function("train/logits_ce"):
            ce = cross_entropy(logits[:, :-1], batch["labels"][:, 1:],
                               batch.get("loss_mask"), tp, dp)
        return ce, {"ce": ce, "aux": torch.zeros((), dtype=torch.float32,
                                                 device=ce.device)}

    @torch.no_grad()
    def prefill(self, params: Dict, tokens: torch.Tensor,
                frontend_embeds: Optional[torch.Tensor] = None,
                tp: Optional[sharding.ModelAxis] = None
                ) -> Tuple[torch.Tensor, Tuple[List, Tuple]]:
        """tokens (B, S) int, frontend_embeds (B, S_enc, d_model). Returns
        (logits (B, V_pad) at the last position, ([], ({k, v, xk, xv},)))
        with ``k`` / ``v`` S long and ``xk`` / ``xv`` S_enc long. With
        ``tp`` (a serve tree, ``sharding.for_serve``) both stacks run on
        the rank's heads, the caches are its kv heads and the logits are
        made whole over the model group."""
        if frontend_embeds is None:
            raise ValueError("an encoder-decoder prefill needs the frame "
                             "embeddings (frontend_embeds)")
        enc_out = self.encode(params, frontend_embeds, tp=tp)
        logits, caches = self._decode_full(params, tokens, enc_out,
                                           want_cache=True, last_only=True,
                                           tp=tp)
        return whole_logits(logits, tp)[:, 0], ([], caches)

    @torch.no_grad()
    def decode_step(self, params: Dict, token: torch.Tensor,
                    caches: Tuple[List, Tuple], cur_len: int,
                    tp: Optional[sharding.ModelAxis] = None
                    ) -> Tuple[torch.Tensor, Tuple[List, Tuple]]:
        """token: (B,) int; cur_len: the position being written, one for the
        whole batch. ``k`` / ``v`` are written in place, ``xk`` / ``xv``
        only read; the caches are returned. With ``tp`` as
        :meth:`prefill`."""
        cfg = self.cfg
        cur_len = int(cur_len)
        _, block_caches = caches
        x = embed_rows(params["embed"]["tokens"], token[:, None],
                       tp).to(self.adt)
        for j in range(cfg.n_layers):
            x, _, _ = apply_pattern_block(
                _index(params["dec_blocks"], j), x, cfg, self.pat, "decode",
                caches=_index(block_caches, j), cur_len=cur_len, cross=True,
                tp=tp)
        with record_function("decode/logits"):
            logits = whole_logits(self._logits(params, x, tp), tp)
        return logits[:, 0], caches

    # -- caches --------------------------------------------------------------
    def decode_cache_specs(self, batch: int, s_max: int, s_enc: int,
                           model_ranks: int = 1) -> Tuple[List, Tuple]:
        """The decode caches' shapes; over a model axis of ``model_ranks``
        one rank's kv heads."""
        cfg = self.cfg
        kv = attn_mod.gqa_cache_spec(cfg, batch, s_max, self.adt, model_ranks)
        xshape = (batch, cfg.n_kv_heads // model_ranks, s_enc, cfg.d_head)
        spec = {**kv, "xk": ShapeDtype(xshape, self.adt),
                "xv": ShapeDtype(xshape, self.adt)}
        stacked = {k: ShapeDtype((cfg.n_layers,) + sd.shape, sd.dtype)
                   for k, sd in spec.items()}
        return [], (stacked,)

    def init_decode_caches(self, batch: int, s_max: int, s_enc: int,
                           model_ranks: int = 1) -> Tuple[List, Tuple]:
        """Zero decode caches on the model's device (a rank's over a model
        axis of ``model_ranks``)."""
        return _map(lambda sd: torch.zeros(sd.shape, dtype=sd.dtype,
                                           device=self.device),
                    self.decode_cache_specs(batch, s_max, s_enc,
                                            model_ranks))
