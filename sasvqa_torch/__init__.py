"""PyTorch/CUDA port of sasvqa_tpu (Self-Adaptive Sampling for Video-QA).

The JAX package ``sasvqa_tpu`` stays the reference.  This package mirrors
its module paths and names so each counterpart is easy to find, imports
nothing from it, and runs its hot path through CUDA kernels written for
Hopper (``ops/csrc``).  Entry points run on the GPU unless the caller
passes ``device="cpu"``.
"""
