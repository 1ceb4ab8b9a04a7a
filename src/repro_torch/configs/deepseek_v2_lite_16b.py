"""deepseek-v2-lite-16b [moe]: 27L d=2048 16H, MLA kv_lora=512, MoE 64 routed
top-6 + 2 shared, expert d_ff=1408, first layer dense (d_ff=10944),
vocab=102400. NOTE: assignment line says both '64e' and '160 routed'; the HF
v2-lite checkpoint has 64 routed + 2 shared — we follow 64 (DESIGN.md §6).
[arXiv:2405.04434; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-v2-lite-16b", family="moe",
    n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16, d_head=128,
    d_ff=10944, vocab_size=102400,
    mla=True, kv_lora_rank=512, qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128,
    n_experts=64, n_shared_experts=2, top_k=6, moe_d_ff=1408,
    first_dense_layers=1, rope_theta=1e4,
)
