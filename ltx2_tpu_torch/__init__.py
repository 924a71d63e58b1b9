"""PyTorch/CUDA port of ltx2_tpu for NVIDIA Hopper GPUs.

Mirrors the JAX package's module layout; imports no JAX and nothing of
ltx2_tpu. Entry points run on "cuda" unless the caller passes device="cpu".
"""
