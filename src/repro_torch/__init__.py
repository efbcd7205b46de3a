"""PyTorch/CUDA port of the MixServe serving system for one NVIDIA H100.

Module layout mirrors the JAX package ``repro`` so each counterpart is found
by name.  Nothing here imports JAX or ``repro``; the CUDA kernels are built
from ``kernels/csrc`` at first use (``kernels.build``).
"""
