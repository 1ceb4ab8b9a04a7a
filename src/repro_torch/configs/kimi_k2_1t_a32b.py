"""kimi-k2-1t-a32b [moe]: 61L d=7168 64H (GQA kv=8) expert d_ff=2048
vocab=163840, MoE 384 experts top-8 (+1 shared), first layer dense
(d_ff=18432). ~1.03T params, ~32B active. Follows the assignment's spec line
(GQA, not MLA). bf16 optimizer moments so state fits 512 chips (DESIGN.md §7).
[arXiv:2501.kimi2; unverified]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="kimi-k2-1t-a32b", family="moe",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8, d_head=128,
    d_ff=18432, vocab_size=163840,
    n_experts=384, n_shared_experts=1, top_k=8, moe_d_ff=2048,
    first_dense_layers=1, rope_theta=1e6,
    opt_moment_dtype="bfloat16",
)
