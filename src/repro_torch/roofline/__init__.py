"""Roofline of one step on an NVIDIA H100 (port of ``repro.roofline``)."""
from . import analysis
