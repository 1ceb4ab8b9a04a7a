"""jamba-v0.1-52b [hybrid]: 32L d=4096 32H (GQA kv=8) d_ff=14336 vocab=65536,
MoE 16e top-2 every other layer, attention:mamba 1:7 (attn at index 4 of each
8-layer block). Jamba v0.1 uses Mamba-1 internals (d_state=16); we realize all
SSM layers with the Mamba-2 SSD formulation (TPU-friendly chunked scan) at the
same state size — documented adaptation (DESIGN.md §11). [arXiv:2403.19887; hf]"""
from .base import ArchConfig, LayerDesc

_A, _S = "attn", "ssm"
_PATTERN = tuple(
    LayerDesc(kind=(_A if i == 4 else _S), mlp=("moe" if i % 2 == 1 else "dense"))
    for i in range(8)
)

CONFIG = ArchConfig(
    name="jamba-v0.1-52b", family="hybrid",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_head=128,
    d_ff=14336, vocab_size=65536,
    pattern=_PATTERN,
    n_experts=16, top_k=2, moe_d_ff=14336,
    ssm_state=16, ssm_expand=2, ssm_head_dim=64, ssm_conv=4, ssm_chunk=128,
    rope_theta=1e4,
)
