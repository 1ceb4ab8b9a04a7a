"""qwen3-14b [dense]: 40L d=5120 40H (GQA kv=8) d_ff=17408 vocab=151936.
qk_norm, no qkv bias. [hf:Qwen/Qwen3-14B; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-14b", family="dense",
    n_layers=40, d_model=5120, n_heads=40, n_kv_heads=8, d_head=128,
    d_ff=17408, vocab_size=151936,
    qk_norm=True, rope_theta=1e6,
)
