"""Hand-written CUDA kernels for Hopper (``csrc/``), their ctypes wrappers
and plain PyTorch versions (``ref.py``); ``ops.py`` dispatches by device."""

import torch
from torch._subclasses.fake_tensor import FakeTensor


def is_fake(t: torch.Tensor) -> bool:
    """Whether ``t`` is a fake tensor (no data: the dry run's), which a
    kernel's wrapper answers without a launch."""
    return isinstance(t, FakeTensor)
