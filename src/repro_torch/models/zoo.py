"""Config → model builder + reduced-config factory for smoke tests (port of
``repro.models.zoo``)."""

from __future__ import annotations

import dataclasses

from ..configs.base import ArchConfig
from ..device import DeviceLike
from .encdec import EncDecLM
from .lm import LM


def build_model(cfg: ArchConfig, attn_impl: str = "k2",
                device: DeviceLike = None) -> LM | EncDecLM:
    """``EncDecLM`` for a config with encoder layers (seamless-m4t), else
    ``LM``: the dense family, the vlm backbone (its frontend stub enters as
    ``frontend_embeds``), the MoE family (MLA or GQA), the SSM family and
    the hybrid.
    ``attn_impl="sdpa"`` for training: K2 has no backward."""
    if cfg.encoder_layers > 0:
        return EncDecLM(cfg, attn_impl=attn_impl, device=device)
    return LM(cfg, attn_impl=attn_impl, device=device)


def reduced_config(cfg: ArchConfig) -> ArchConfig:
    """Same family/topology, toy sizes: small layers and width, few experts,
    tiny embedding tables — runnable on one CPU in seconds. Field for field
    the reference's."""
    pat = cfg.layer_pattern()
    upd: dict = dict(
        name=cfg.name + "-reduced",
        n_layers=cfg.first_dense_layers + len(pat),
        d_model=64,
        d_ff=0 if cfg.d_ff == 0 else 128,
        vocab_size=512,
        param_dtype="float32",
        activation_dtype="float32",
        remat="none",
    )
    if cfg.n_heads:
        upd.update(n_heads=4, n_kv_heads=2 if cfg.n_kv_heads < cfg.n_heads else 4,
                   d_head=16)
    if cfg.n_experts:
        upd.update(n_experts=8, top_k=min(cfg.top_k, 2),
                   moe_d_ff=32, capacity_factor=4.0,
                   n_shared_experts=min(cfg.n_shared_experts, 1))
    if cfg.mla:
        upd.update(kv_lora_rank=32, qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16)
    if any(ld.kind == "ssm" for ld in pat):
        upd.update(ssm_state=16, ssm_expand=2, ssm_head_dim=16, ssm_conv=4,
                   ssm_chunk=16)
    if cfg.encoder_layers:
        upd.update(encoder_layers=2, n_layers=2)
    if cfg.frontend != "none":
        upd.update(frontend_tokens=8)
    return dataclasses.replace(cfg, **upd)
