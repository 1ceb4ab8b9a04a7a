"""yi-9b [dense]: 48L d=4096 32H (GQA kv=4) d_ff=11008 vocab=64000.
llama-arch GQA (depth-extended yi-6b). [arXiv:2403.04652; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="yi-9b", family="dense",
    n_layers=48, d_model=4096, n_heads=32, n_kv_heads=4, d_head=128,
    d_ff=11008, vocab_size=64000, rope_theta=5e6,
)
