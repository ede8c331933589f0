"""PyTorch/CUDA port of ``repro`` for NVIDIA Hopper (H100).

Mirrors ``src/repro/`` module for module; imports neither ``jax`` nor
``repro``.  Ported so far: the pipelined serving path (prefill, then greedy
decode) and the pipelined zero-bubble training step under every schedule
of the JAX launcher (1F1B, ZB-H1, ZB-H2, ZB-1p, ZB-2p; ZB-V, V-Min, V-Half
on two chunks a stage; B/W split, tick executor, AdamW with
post-validation) of the dense GQA decoder, all p stages on one card, with two hand-written CUDA kernels:
RMSNorm (``kernels/csrc/rmsnorm.cu``) and the weight-gradient accumulation
of the W pass (``kernels/csrc/wgrad_accum.cu``).
"""
