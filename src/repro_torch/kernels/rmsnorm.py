"""RMSNorm forward: the CUDA kernel ``csrc/rmsnorm.cu`` and its wrapper.

The kernel replaces the TPU kernel ``src/repro/kernels/rmsnorm.py::
rmsnorm_fused``; the source note in ``csrc/rmsnorm.cu`` says what bounds it.
:func:`rmsnorm_fused` launches it on CUDA tensors only, and counts each
launch in the module-level integer ``launches``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build

__all__ = ["rmsnorm_fused", "check_args", "launches"]

launches = 0  # kernel launches since the caller last set it to 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def check_args(x: torch.Tensor, g: torch.Tensor) -> None:
    """Raise on what the kernel does not take (both devices check alike)."""
    if x.dim() < 2:
        raise ValueError(f"rmsnorm: x must have rank >= 2, got shape {tuple(x.shape)}")
    if g.shape != (x.shape[-1],):
        raise ValueError(f"rmsnorm: g shape {tuple(g.shape)} != ({x.shape[-1]},)")
    if x.dtype not in _DTYPE_CODE or g.dtype not in _DTYPE_CODE:
        raise TypeError(f"rmsnorm: dtypes x={x.dtype} g={g.dtype}; want float32 or bfloat16")
    if x.device != g.device:
        raise ValueError(f"rmsnorm: x on {x.device}, g on {g.device}")
    if not (x.is_contiguous() and g.is_contiguous()):
        raise ValueError("rmsnorm: x and g must be contiguous (call .contiguous() first)")
    if x.numel() == 0:
        raise ValueError(f"rmsnorm: empty input {tuple(x.shape)}")


@functools.lru_cache(maxsize=None)
def _fn():
    f = build.load("rmsnorm").rmsnorm_fwd
    f.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                  ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    f.restype = ctypes.c_int
    return f


def rmsnorm_fused(x: torch.Tensor, g: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Launch the kernel on CUDA tensors x (..., H), g (H,) -> y like x."""
    global launches
    check_args(x, g)
    if x.device.type != "cuda":
        raise ValueError(f"rmsnorm_fused: the CUDA kernel needs CUDA tensors, got {x.device}")
    h = x.shape[-1]
    n = x.numel() // h
    y = torch.empty_like(x)
    dev = x.device.index
    args = (x.data_ptr(), g.data_ptr(), y.data_ptr(), n, h,
            _DTYPE_CODE[x.dtype], _DTYPE_CODE[g.dtype], eps,
            torch.cuda.current_stream(dev).cuda_stream)
    if dev == torch.cuda.current_device():
        err = _fn()(*args)
    else:  # the launch goes to the calling thread's current device
        with torch.cuda.device(dev):
            err = _fn()(*args)
    if err != 0:
        raise RuntimeError(f"rmsnorm_fwd launch failed: CUDA error {err} (n={n}, h={h})")
    launches += 1
    return y
