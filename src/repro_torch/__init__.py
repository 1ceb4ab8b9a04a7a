"""repro_torch — the PyTorch/CUDA port of ``repro`` (the BioDynaMo engine).

Mirrors ``repro``'s layout and public names; imports neither ``jax`` nor
``repro``. Entry points run on the CUDA card unless the caller passes
``device="cpu"`` (device.py).
"""

from .device import resolve_device

__all__ = ["resolve_device"]
