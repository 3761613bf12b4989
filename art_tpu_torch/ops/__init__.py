"""Intersection, shading and refill: plain PyTorch functions and the CUDA
kernel wrappers (``*_kernel*.py``) that replace art_tpu's Pallas kernels."""
