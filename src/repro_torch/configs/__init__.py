"""Architecture registry: the 10 assigned architectures — the port's own
copy of ``repro.configs`` (tests hold ``ARCHS`` equal field for field)."""

from .base import (ALL_SHAPES, DECODE_32K, LONG_500K, PREFILL_32K, TRAIN_4K,
                   ArchConfig, LayerDesc, ShapeSpec, shape_applicable)

from . import (deepseek_v2_lite_16b, jamba_v0_1_52b, kimi_k2_1t_a32b,
               mamba2_370m, phi_3_vision_4_2b, qwen2_1_5b, qwen3_14b,
               seamless_m4t_large_v2, yi_6b, yi_9b)

ARCHS = {m.CONFIG.name: m.CONFIG for m in (
    qwen2_1_5b, qwen3_14b, yi_6b, yi_9b, seamless_m4t_large_v2,
    kimi_k2_1t_a32b, deepseek_v2_lite_16b, jamba_v0_1_52b, mamba2_370m,
    phi_3_vision_4_2b)}

SHAPES = {s.name: s for s in ALL_SHAPES}

__all__ = ["ARCHS", "SHAPES", "ArchConfig", "LayerDesc", "ShapeSpec",
           "shape_applicable", "TRAIN_4K", "PREFILL_32K", "DECODE_32K",
           "LONG_500K", "ALL_SHAPES"]
