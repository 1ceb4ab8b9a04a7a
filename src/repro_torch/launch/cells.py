"""Dry-run cell assembly for every (arch × shape) (port of
``repro.launch.cells``).

``build_cell`` returns a step function with ``ShapeDtype`` stand-ins for
every input (nothing allocated) and the matching spec trees: one resolved
spec a leaf, each entry None, a mesh axis name or a tuple of names
(``models/layers.resolve_spec``). ``launch/dryrun.py`` traces the step on
them and reckons per-device bytes on the mesh. Also here: the microbatch
count of each cell, the active parameter count, the analytic FLOPs of one
step and the depth probe.

The reference's ``unroll_scan`` has no counterpart: the port's layers are
a Python loop, which every trace sees whole.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..configs.base import ArchConfig, LayerDesc, ShapeSpec
from ..models.layers import MeshAxes, ShapeDtype, torch_dtype

# per-cell microbatch counts (activation-memory fits; FLOPs unchanged)
MICROBATCHES: Dict[Tuple[str, str], int] = {
    ("kimi-k2-1t-a32b", "train_4k"): 16,
    ("jamba-v0.1-52b", "train_4k"): 4,
    ("deepseek-v2-lite-16b", "train_4k"): 2,
    ("qwen3-14b", "train_4k"): 2,
    ("yi-9b", "train_4k"): 2,
}


def microbatches(arch: str, shape: str) -> int:
    return MICROBATCHES.get((arch, shape), 1)


def _batch_axes(axes: MeshAxes):
    b = axes.batch
    return b if len(b) > 1 else b[0]


@dataclasses.dataclass
class Cell:
    """Everything the dry run needs to trace one (arch × shape) on one
    mesh."""
    fn: Callable                  # the step function
    args: Tuple                   # ShapeDtype trees
    in_shardings: Tuple           # spec trees of the same structure
    model: Any
    n_params: int
    n_active_params: int
    model_flops: float            # 6ND train / 2ND decode-prefill
    note: str = ""


def map_structs(fn: Callable, tree: Any) -> Any:
    """``fn`` of every ``ShapeDtype`` leaf of a tree of dicts, lists and
    tuples."""
    if isinstance(tree, dict):
        return {k: map_structs(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, ShapeDtype):
        return type(tree)(map_structs(fn, v) for v in tree)
    return fn(tree)


def leaves_with_specs(structs: Any, specs: Any, path: Tuple = ()):
    """Yield ``(path, leaf, spec)`` for every leaf of ``structs``, walking
    ``specs`` along the same structure (its leaves are tuples, so its own
    structure cannot say where a leaf is). A path holds dict keys and
    sequence indices."""
    if isinstance(structs, dict):
        for k, v in structs.items():
            yield from leaves_with_specs(v, specs[k], path + (k,))
    elif isinstance(structs, (list, tuple)) \
            and not isinstance(structs, ShapeDtype):
        for i, v in enumerate(structs):
            yield from leaves_with_specs(v, specs[i], path + (i,))
    else:
        yield path, structs, specs


def _count_active_params(model, cfg: ArchConfig) -> int:
    """Total params minus the unrouted share of expert weights."""
    total = model.ps.n_params()
    if not cfg.n_experts:
        return total
    expert = sum(math.prod(i.shape) for p, i in model.ps.infos.items()
                 if "/moe/w_" in p)
    return int(total - expert * (1.0 - cfg.top_k / cfg.n_experts))


def analytic_step_flops(cfg: ArchConfig, shape: ShapeSpec) -> float:
    """FLOPs of one step of ``shape.global_batch`` sequences, from the
    architecture alone. Conventions: a matmul is 2·m·n·k; causal attention
    sees S/2 keys on average (decode the whole cache); training is 3
    passes, 4 with ``remat="full"`` (the recompute); the routed experts
    count ``top_k`` × the capacity factor of rows a token."""
    d, v = cfg.d_model, ((cfg.vocab_size + 127) // 128) * 128
    s, b = shape.seq_len, shape.global_batch

    def attn_layer(per_ctx: float) -> float:
        if cfg.mla:
            r, dn, dr, dv = (cfg.kv_lora_rank, cfg.qk_nope_dim,
                             cfg.qk_rope_dim, cfg.v_head_dim)
            h = cfg.n_heads
            proj = 2 * d * h * (dn + dr) + 2 * d * (r + dr) \
                + 2 * r * h * (dn + dv) + 2 * h * dv * d
            attn = 2 * 2 * per_ctx * h * (dn + dr + dv) / 2
        else:
            h, hk, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
            proj = 2 * d * (h + 2 * hk) * dh + 2 * h * dh * d
            attn = 2 * 2 * per_ctx * h * dh        # scores + values, avg ctx
        return proj + attn

    def mlp_dense() -> float:
        return 3 * 2 * d * cfg.d_ff

    def mlp_moe() -> float:
        f = cfg.moe_d_ff
        routed = 3 * 2 * cfg.top_k * cfg.capacity_factor * d * f
        shared = 3 * 2 * d * f * cfg.n_shared_experts
        return 2 * d * cfg.n_experts + routed + shared

    def ssm_layer(per_ctx: float) -> float:
        di = cfg.ssm_expand * d
        h = di // cfg.ssm_head_dim
        n = cfg.ssm_state
        proj = 2 * d * (2 * di + 2 * n + h) + 2 * di * d
        l = min(cfg.ssm_chunk, max(int(per_ctx), 1))
        ssd = 2 * l * n + 2 * l * di + 8 * di * n   # intra + states, a token
        return proj + ssd

    # per-token FLOPs of one pass over every layer
    per_ctx = s / 2 if shape.kind != "decode" else s
    total = 2 * d * v                                   # logits
    pat = cfg.layer_pattern()
    reps = (cfg.n_layers - cfg.first_dense_layers) // len(pat)
    layers = [LayerDesc(kind="attn", mlp="dense")] * cfg.first_dense_layers \
        + list(pat) * reps
    for ld in layers:
        total += attn_layer(per_ctx) if ld.kind == "attn" \
            else ssm_layer(per_ctx)
        if ld.mlp == "dense":
            total += mlp_dense()
        elif ld.mlp == "moe":
            total += mlp_moe()
    if cfg.encoder_layers:
        total += sum(attn_layer(s / 2) + mlp_dense()
                     for _ in range(cfg.encoder_layers))

    n_tokens = b * (1 if shape.kind == "decode" else s)
    passes = 1.0
    if shape.kind == "train":
        passes = 3.0 + (1.0 if cfg.remat == "full" else 0.0)
    return float(total) * n_tokens * passes


def probe_config(cfg: ArchConfig, k: int) -> ArchConfig:
    """Depth-k variant for per-block probing: the dense prefix and k
    pattern blocks (k encoder and k decoder layers for an encoder-decoder).
    The difference of the depth-1 and depth-2 cells isolates one block."""
    pat = cfg.layer_pattern()
    upd: dict = {"n_layers": cfg.first_dense_layers + len(pat) * k}
    if cfg.encoder_layers:
        upd["encoder_layers"] = k
        upd["n_layers"] = k
    return dataclasses.replace(cfg, **upd)


def _param_structs(model, axes: MeshAxes) -> Tuple[Any, Any]:
    return model.ps.shape_tree(), model.ps.spec_tree(axes)


def _opt_structs(model, cfg: ArchConfig, axes: MeshAxes) -> Tuple[Any, Any]:
    mdt = torch_dtype(cfg.opt_moment_dtype)

    def moments():
        return map_structs(lambda sd: ShapeDtype(sd.shape, mdt),
                           model.ps.shape_tree())
    state = {"mu": moments(), "nu": moments(),
             "step": ShapeDtype((), torch.int32)}
    specs = {"mu": model.ps.spec_tree(axes), "nu": model.ps.spec_tree(axes),
             "step": ()}
    return state, specs


def _batch_structs(cfg: ArchConfig, shape: ShapeSpec, axes: MeshAxes,
                   adt: torch.dtype) -> Tuple[Dict, Dict]:
    b, s = shape.global_batch, shape.seq_len
    ba = _batch_axes(axes)
    tok = ShapeDtype((b, s), torch.int32)
    batch = {"tokens": tok, "labels": tok}
    specs = {"tokens": (ba, None), "labels": (ba, None)}
    if cfg.encoder_layers > 0:
        # enc-dec: frames on the encoder, tokens on the decoder (both seq_len)
        batch["frontend_embeds"] = ShapeDtype((b, s, cfg.d_model), adt)
        specs["frontend_embeds"] = (ba, None, None)
    elif cfg.frontend != "none":
        batch["frontend_embeds"] = ShapeDtype(
            (b, cfg.frontend_tokens, cfg.d_model), adt)
        specs["frontend_embeds"] = (ba, None, None)
    return batch, specs


def _cache_shardings(cfg: ArchConfig, shape: ShapeSpec, axes: MeshAxes,
                     cache_specs: Any, cache_seq_axis: Optional[str] = None
                     ) -> Any:
    """decode_32k: shard caches on batch. long_500k (B=1): shard the
    sequence axis of attention caches over 'data' (sequence-parallel
    decode); small SSM states stay replicated. ``cache_seq_axis`` also
    shards the KV sequence dim of a batched cache over that axis."""
    ba = _batch_axes(axes)
    seq_parallel = shape.global_batch == 1

    def leaf_spec(sd: ShapeDtype) -> Tuple:
        dims: list = [None] * len(sd.shape)
        if seq_parallel:
            for i, d in enumerate(sd.shape):
                if d == shape.seq_len:
                    dims[i] = "data"
                    break
        else:
            # batch axis: the axis matching global_batch (after the
            # optional leading n_blocks stack dim)
            for i, d in enumerate(sd.shape):
                if d == shape.global_batch:
                    dims[i] = ba
                    break
            if cache_seq_axis:
                for i, d in enumerate(sd.shape):
                    if d == shape.seq_len and dims[i] is None:
                        dims[i] = cache_seq_axis
                        break
        return tuple(dims)

    return map_structs(leaf_spec, cache_specs)


def build_cell(cfg: ArchConfig, shape: ShapeSpec, mesh, axes: MeshAxes,
               attn_impl: str = "sdpa", force_micro: Optional[int] = None,
               grad_sync_dtype: Optional[str] = None,
               cache_seq_axis: Optional[str] = None) -> Cell:
    """The step of ``shape.kind`` for ``cfg`` with its inputs at
    ``shape``'s global sizes and their specs on ``axes``; every spec must
    name only axes of ``mesh`` (ValueError otherwise). The model is built
    on the ``meta`` device: it allocates nothing, and a caller who runs the
    step makes its tensors itself (``model.ps.init_params`` on a
    generator of the device wanted)."""
    from ..models import build_model
    from ..train import AdamWConfig
    from ..train.train_step import (make_decode_step, make_prefill_step,
                                    make_train_step)

    model = build_model(cfg, attn_impl=attn_impl, device="meta")
    adt = torch_dtype(cfg.activation_dtype)
    n_params = model.ps.n_params()
    n_active = _count_active_params(model, cfg)
    tokens = shape.global_batch * shape.seq_len
    param_shapes, param_specs = _param_structs(model, axes)

    if shape.kind == "train":
        opt_cfg = AdamWConfig(moment_dtype=cfg.opt_moment_dtype)
        opt_shapes, opt_specs = _opt_structs(model, cfg, axes)
        batch, batch_specs = _batch_structs(cfg, shape, axes, adt)
        nm = force_micro or microbatches(cfg.name, shape.name)
        fn = make_train_step(model, opt_cfg, n_microbatches=nm,
                             grad_sync_dtype=grad_sync_dtype)
        cell = Cell(fn=fn, args=(param_shapes, opt_shapes, batch),
                    in_shardings=(param_specs, opt_specs, batch_specs),
                    model=model, n_params=n_params, n_active_params=n_active,
                    model_flops=6.0 * n_active * tokens,
                    note=f"microbatches={nm}")
    elif shape.kind == "prefill":
        batch, batch_specs = _batch_structs(cfg, shape, axes, adt)
        batch.pop("labels")
        batch_specs.pop("labels")
        cell = Cell(fn=make_prefill_step(model), args=(param_shapes, batch),
                    in_shardings=(param_specs, batch_specs),
                    model=model, n_params=n_params, n_active_params=n_active,
                    model_flops=2.0 * n_active * tokens)
    else:
        # decode: one new token against a seq_len-deep cache
        b, s_max = shape.global_batch, shape.seq_len
        if cfg.encoder_layers > 0:
            cache = model.decode_cache_specs(b, s_max, s_enc=s_max)
        else:
            cache = model.decode_cache_specs(b, s_max)
        cache_specs = _cache_shardings(cfg, shape, axes, cache,
                                       cache_seq_axis=cache_seq_axis)
        token_spec = (_batch_axes(axes) if b > 1 else None,)
        decode = make_decode_step(model)

        def decode_last(params, token, caches, cur_len):
            # the port's decode step takes the position as a host int: the
            # cell writes the last one, s_max - 1, so attention reads the
            # whole cache; ``cur_len`` is the reference's scalar input
            return decode(params, token, caches, s_max - 1)
        cell = Cell(fn=decode_last,
                    args=(param_shapes, ShapeDtype((b,), torch.int32), cache,
                          ShapeDtype((), torch.int32)),
                    in_shardings=(param_specs, token_spec, cache_specs, ()),
                    model=model, n_params=n_params, n_active_params=n_active,
                    model_flops=2.0 * n_active * b)
    for _, _, spec in leaves_with_specs(cell.args, cell.in_shardings):
        for entry in spec:
            mesh.axis_size(entry)
    return cell
