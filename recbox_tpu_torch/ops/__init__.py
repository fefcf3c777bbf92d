"""Kernels of the port and their plain PyTorch versions (`csrc/` holds the
CUDA sources, `_build.py` builds them at first use)."""
