"""Hand-written CUDA kernels for Hopper (``csrc/``), their ctypes wrappers
and plain PyTorch versions (``ref.py``); ``ops.py`` dispatches by device."""
