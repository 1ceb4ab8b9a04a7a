"""repro_torch.models — the LM substrate (port of ``repro.models``): the
dense family and the vlm backbone (serving and training), the MoE family
with MLA or GQA attention, the SSM family and the hybrid (serving)."""

from .lm import LM
from .zoo import build_model, reduced_config

__all__ = ["LM", "build_model", "reduced_config"]
