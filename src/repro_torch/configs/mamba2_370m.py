"""mamba2-370m [ssm]: 48L d=1024 attn-free vocab=50280, ssm_state=128,
expand=2, headdim=64 — SSD (state-space duality). [arXiv:2405.21060; unverified]"""
from .base import ArchConfig, LayerDesc

CONFIG = ArchConfig(
    name="mamba2-370m", family="ssm",
    n_layers=48, d_model=1024, n_heads=0, n_kv_heads=0, d_head=0,
    d_ff=0, vocab_size=50280,
    pattern=(LayerDesc(kind="ssm", mlp="none"),),
    ssm_state=128, ssm_expand=2, ssm_head_dim=64, ssm_conv=4, ssm_chunk=128,
    tie_embeddings=True,
)
