"""phi-3-vision-4.2b [vlm]: 32L d=3072 32H (kv=32: MHA) d_ff=8192 vocab=32064.
phi3-mini backbone + CLIP frontend; the vision tower is a STUB — input_specs()
provides precomputed patch embeddings prepended to token embeddings
(assignment rule). [hf:microsoft/Phi-3-vision-128k-instruct; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="phi-3-vision-4.2b", family="vlm",
    n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32, d_head=96,
    d_ff=8192, vocab_size=32064, rope_theta=1e4,
    frontend="vision_patches", frontend_tokens=576,
)
