"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version (csrc/ holds the sources; build.py compiles them at first use)."""
