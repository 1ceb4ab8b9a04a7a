"""train_step / serve_step factories (port of ``repro.train.train_step``).

``make_train_step`` returns a function (params, opt_state, batch) →
(params, opt_state, metrics), with optional microbatch gradient
accumulation: the batch's leading axis splits into ``n_microbatches``
slices, run one after another (activation memory ∝ 1/n, FLOPs unchanged),
their gradients summed into f32 buffers and divided by n.

Gradients come from ``torch.autograd.grad`` on the parameter leaves; the
caller's parameter tensors need not require grad (the step takes detached
views of them). ``make_prefill_step`` / ``make_decode_step`` are the
serving entry points: over a (1, T) mesh they take the serve tree of
``sharding.for_serve`` (made once, as the reference's jitted serving
steps take their sharded params) and its model axis.

On parameters sharded over a mesh (DTensor blocks from
``init_params(generator, mesh, axes)``) the batch is the rank's own rows
(``data.rank_batch_at(..., n_microbatches)``: its block of each global
microbatch, so microbatch i of every rank is its block of the reference's
microbatch i) and the step is data-parallel: the model gathers the
weights and reduce-scatters each gradient into the rank's block
(``models/sharding.py``). Each rank's loss is the mean over its rows, or
a statistic of the global microbatch held whole on every rank (the MoE
aux loss, a masked CE: their sums over the data ranks sum the gradient
back too), so the summed gradient is divided by the data axis's ranks W,
and the logged loss is the mean all-reduced over them. Across
microbatches the losses are averaged, as the reference's scan does. On a
tensor-parallel mesh the ranks of one data coordinate take the same rows
and hold the same loss; the model axis's sums are inside the layers.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
import torch.distributed as dist
from torch.profiler import record_function

from ..models import sharding
from . import optimizer as opt_mod
from .optimizer import _leaves, _unflatten

_SYNC_DTYPES = {None: None, "float32": None, "bfloat16": torch.bfloat16}


def microbatch(batch: Dict[str, torch.Tensor], n: int, i: int
               ) -> Dict[str, torch.Tensor]:
    """Microbatch ``i`` of ``n`` of ``batch``: block i of its rows. A data
    rank's rows come from ``data.rank_batch_at(..., n)``, laid out so
    that this block is the rank's block of the global microbatch i; pass
    it the step's own ``n_microbatches`` (an attribute of the function
    :func:`make_train_step` returns)."""
    return {k: v.reshape((n, v.shape[0] // n) + v.shape[1:])[i]
            for k, v in batch.items()}


def make_train_step(model, opt_cfg: opt_mod.AdamWConfig,
                    n_microbatches: int = 1,
                    grad_sync_dtype: Optional[str] = None) -> Callable:
    """``grad_sync_dtype="bfloat16"`` casts each (micro)batch's gradients
    to bf16 before the microbatches are summed; the moments still take
    the dequantised f32 value. Over ranks the cast comes after the
    gradients are summed over the data axis, as in the reference's
    compiled program: its GSPMD partitioner sums each gradient in the
    gradient's own dtype where the backward makes it and casts after
    (its docstring's "before the data-parallel reduction" is not what
    XLA compiles, so a per-rank cast would round differently). Sharded
    parameters and moments are updated in place (``apply_updates``).
    Metrics: ``loss`` (the mean over microbatches, and over ranks),
    ``grad_norm``, ``lr``, all device tensors. The returned function's
    ``n_microbatches`` is the count its batches' rows must be laid out
    for (``data.rank_batch_at``)."""
    sync_dt = _SYNC_DTYPES[grad_sync_dtype]

    def loss_and_grads(params, batch):
        leaves = [p.detach().requires_grad_(True) for p in _leaves(params)]
        with torch.enable_grad():
            loss, _ = model.train_loss(_unflatten(params, iter(leaves)),
                                       batch)
            with record_function("train/backward"):
                grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                            materialize_grads=True)
        grads = [sharding.local(g) for g in grads]
        if sync_dt is not None:
            grads = [g.to(sync_dt) for g in grads]
        return loss.detach(), grads

    def train_step(params, opt_state, batch):
        group, _, world = sharding.world_of(params)
        if n_microbatches == 1:
            loss, grads = loss_and_grads(params, batch)
        else:
            n = n_microbatches
            grads = [torch.zeros_like(sharding.local(p),
                                      dtype=torch.float32)
                     for p in _leaves(params)]
            loss = torch.zeros((), dtype=torch.float32,
                               device=grads[0].device)
            for i in range(n):
                l_i, g_i = loss_and_grads(params, microbatch(batch, n, i))
                for acc, g in zip(grads, g_i):
                    acc += g.float()
                loss = loss + l_i
                del g_i
            for g in grads:         # in place: one f32 copy of the grads
                g.div_(n)
            loss = loss / n
        if group is not None:
            if world > 1:
                for g in grads:
                    g.div_(world)
            dist.all_reduce(loss, group=group)
            loss = loss / world
        with record_function("train/adamw"):
            params, opt_state, om = opt_mod.apply_updates(
                opt_cfg, params, _unflatten(params, iter(grads)), opt_state)
        return params, opt_state, {"loss": loss, **om}

    train_step.n_microbatches = n_microbatches
    return train_step


def make_prefill_step(model, tp: Optional[sharding.ModelAxis] = None
                      ) -> Callable:
    """(params, batch) → (last-position logits, caches). With ``tp`` the
    params are the serve tree it came with (``sharding.for_serve``)."""
    def prefill_step(params, batch: Dict[str, torch.Tensor]):
        return model.prefill(params, batch["tokens"],
                             batch.get("frontend_embeds"), tp=tp)

    return prefill_step


def make_decode_step(model, tp: Optional[sharding.ModelAxis] = None
                     ) -> Callable:
    """(params, token, caches, cur_len) → (logits, caches), the caches
    written in place. With ``tp`` as :func:`make_prefill_step`, the caches
    the rank's (``init_decode_caches(..., model_ranks=tp.size)``)."""
    def decode_step(params, token, caches, cur_len):
        return model.decode_step(params, token, caches, cur_len, tp=tp)

    return decode_step
