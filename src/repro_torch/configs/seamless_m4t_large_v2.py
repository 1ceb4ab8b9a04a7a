"""seamless-m4t-large-v2 [audio]: enc-dec 24L+24L d=1024 16H (kv=16) d_ff=8192
vocab=256206. Audio frontend is a STUB: input_specs() provides precomputed
frame embeddings (assignment rule). [arXiv:2308.11596; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-large-v2", family="encdec",
    n_layers=24, encoder_layers=24,
    d_model=1024, n_heads=16, n_kv_heads=16, d_head=64,
    d_ff=8192, vocab_size=256206, rope_theta=1e4,
    frontend="audio_frames", frontend_tokens=512,
)
