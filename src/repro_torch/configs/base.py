"""Architecture configuration schema + input-shape sets (the port's own copy
of ``repro.configs.base``: pure dataclasses, field for field the same).

Every assigned architecture is an ``ArchConfig``; the four assigned input
shapes are ``ShapeSpec``s. ``LAYER PATTERNS``: a model is a repeating pattern
of layer descriptors scanned ``n_layers / len(pattern)`` times — this keeps
HLO small (fast multi-pod compiles) and makes hybrid interleaves (Jamba 1:7)
first-class.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class LayerDesc:
    """One layer inside the repeating block pattern."""
    kind: str            # "attn" | "ssm"
    mlp: str             # "dense" | "moe" | "none"


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                       # dense | moe | hybrid | ssm | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 128
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 1e6
    tie_embeddings: bool = False
    norm_eps: float = 1e-6

    # layer pattern (repeating); None → [attn+dense] * 1
    pattern: Optional[Tuple[LayerDesc, ...]] = None
    first_dense_layers: int = 0       # leading layers forced to dense MLP (MoE archs)

    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    # dispatch mechanics (hillclimb knobs; EXPERIMENTS.md §Perf):
    #   scatter: tokens scatter-added into (E,cap,D) buffers (baseline)
    #   gather:  int32 slot→token map scattered, activations gathered —
    #            the heavy cross-shard movement becomes one bf16 all-gather
    moe_dispatch: str = "scatter"
    # replicate the expert-FFN dim (weights small enough): removes the
    # (E,cap,D) partial-sum all-reduce of the down-projection entirely
    moe_ffn_unsharded: bool = False

    # MLA (DeepSeek compressed KV)
    mla: bool = False
    kv_lora_rank: int = 0
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128

    # SSM (Mamba2 / SSD)
    ssm_state: int = 128
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    ssm_chunk: int = 128

    # encoder-decoder
    encoder_layers: int = 0           # >0 → enc-dec model

    # modality frontend stubs (audio/vision): the dry-run feeds precomputed
    # frame/patch embeddings of this length; 0 → pure token model
    frontend: str = "none"            # none | audio_frames | vision_patches
    frontend_tokens: int = 0

    # numerics / memory policy
    param_dtype: str = "bfloat16"
    activation_dtype: str = "bfloat16"
    remat: str = "full"               # none | dots | full
    opt_moment_dtype: str = "float32" # bf16 for the 1T config (DESIGN.md §7)

    @property
    def is_subquadratic(self) -> bool:
        """True if decode cost per token does not scale with full attention over
        the whole context on every layer (SSM / hybrid)."""
        return self.family in ("ssm", "hybrid")

    def layer_pattern(self) -> Tuple[LayerDesc, ...]:
        if self.pattern is not None:
            return self.pattern
        return (LayerDesc(kind="attn", mlp="moe" if self.n_experts else "dense"),)

    @property
    def n_blocks(self) -> int:
        pat = self.layer_pattern()
        assert self.n_layers % len(pat) == 0, (self.name, self.n_layers, len(pat))
        return self.n_layers // len(pat)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                         # "train" | "prefill" | "decode"


TRAIN_4K = ShapeSpec("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeSpec("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeSpec("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeSpec("long_500k", 524288, 1, "decode")

ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)


def shape_applicable(cfg: ArchConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """Assignment rules: long_500k only for sub-quadratic archs."""
    if shape.name == "long_500k" and not cfg.is_subquadratic:
        return False, ("skip: pure full-attention arch — 500k-token decode "
                       "requires sub-quadratic attention (DESIGN.md §6)")
    return True, ""
