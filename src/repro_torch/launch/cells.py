"""Per-cell step accounting that needs no device (port of the
device-independent part of ``repro.launch.cells``): the microbatch count
of each (arch × shape) cell, the active parameter count, and the analytic
FLOPs of one step.

The reference's ``input_specs``, ``cell_shardings`` and the dry run they
feed lower XLA programs onto a TPU mesh; they wait for ROADMAP.md Queue 1
item 18, with ``dryrun``, ``hillclimb``, ``mesh`` and ``roofline/``.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

from ..configs.base import ArchConfig, LayerDesc, ShapeSpec

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
