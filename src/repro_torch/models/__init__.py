"""repro_torch.models — the LM substrate (port of ``repro.models``): the
dense family, the vlm backbone and the encoder-decoder (serving and
training), the MoE family with MLA or GQA attention, the SSM family and
the hybrid (serving)."""

from .encdec import EncDecLM
from .lm import LM
from .zoo import build_model, reduced_config

__all__ = ["EncDecLM", "LM", "build_model", "reduced_config"]
