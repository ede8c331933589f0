"""Weight-gradient accumulation ``out = acc + a^T @ g``: the CUDA kernel
``csrc/wgrad_accum.cu`` and its wrapper.

The kernel replaces the TPU kernel ``src/repro/kernels/wgrad_accum.py::
wgrad_accum``; the source note in ``csrc/wgrad_accum.cu`` says what bounds it.
:func:`wgrad_accum_cuda` launches it on CUDA tensors only, and counts each
launch in the module-level integer ``launches``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build

__all__ = ["wgrad_accum_cuda", "check_args", "launches"]

launches = 0  # kernel launches since the caller last set it to 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def check_args(a: torch.Tensor, g: torch.Tensor, acc: torch.Tensor) -> None:
    """Raise on what the kernel does not take (both devices check alike)."""
    if a.dim() != 2 or g.dim() != 2 or acc.dim() != 2:
        raise ValueError(
            f"wgrad_accum: want a (N, H), g (N, F), acc (H, F); got "
            f"{tuple(a.shape)}, {tuple(g.shape)}, {tuple(acc.shape)}"
        )
    n, h = a.shape
    if g.shape[0] != n or acc.shape != (h, g.shape[1]):
        raise ValueError(
            f"wgrad_accum: shapes a {tuple(a.shape)}, g {tuple(g.shape)}, acc "
            f"{tuple(acc.shape)} do not make acc + a^T @ g"
        )
    if a.dtype not in _DTYPE_CODE or g.dtype != a.dtype:
        raise TypeError(f"wgrad_accum: a={a.dtype} g={g.dtype}; want both float32 or bfloat16")
    if acc.dtype != torch.float32:
        raise TypeError(f"wgrad_accum: acc is {acc.dtype}; the kernel accumulates in float32")
    if not (a.device == g.device == acc.device):
        raise ValueError(f"wgrad_accum: a on {a.device}, g on {g.device}, acc on {acc.device}")
    if not (a.is_contiguous() and g.is_contiguous() and acc.is_contiguous()):
        raise ValueError("wgrad_accum: a, g and acc must be contiguous (call .contiguous() first)")
    if a.numel() == 0 or g.numel() == 0:
        raise ValueError(f"wgrad_accum: empty input a {tuple(a.shape)}, g {tuple(g.shape)}")


@functools.lru_cache(maxsize=None)
def _fn():
    f = build.load("wgrad_accum").wgrad_accum
    f.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                  ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                  ctypes.c_void_p]
    f.restype = ctypes.c_int
    return f


def wgrad_accum_cuda(a: torch.Tensor, g: torch.Tensor, acc: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on CUDA tensors: a (N, H), g (N, F), acc (H, F)
    float32 -> a new (H, F) float32 tensor ``acc + a^T @ g``."""
    global launches
    check_args(a, g, acc)
    if a.device.type != "cuda":
        raise ValueError(f"wgrad_accum_cuda: the CUDA kernel needs CUDA tensors, got {a.device}")
    (n, h), f = a.shape, g.shape[1]
    out = torch.empty_like(acc)
    dev = a.device.index
    args = (a.data_ptr(), g.data_ptr(), acc.data_ptr(), out.data_ptr(), n, h, f,
            _DTYPE_CODE[a.dtype], torch.cuda.current_stream(dev).cuda_stream)
    if dev == torch.cuda.current_device():
        err = _fn()(*args)
    else:  # the launch goes to the calling thread's current device
        with torch.cuda.device(dev):
            err = _fn()(*args)
    if err != 0:
        raise RuntimeError(f"wgrad_accum launch failed: CUDA error {err} (n={n}, h={h}, f={f})")
    launches += 1
    return out
