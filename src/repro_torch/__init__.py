"""PyTorch/CUDA port of ``repro`` for NVIDIA Hopper (H100).

Mirrors ``src/repro/`` module for module; imports neither ``jax`` nor
``repro``.  This slice ports the pipelined serving path (prefill, then
greedy decode) of the dense GQA decoder, with a hand-written RMSNorm CUDA
kernel (``kernels/csrc/rmsnorm.cu``).
"""
