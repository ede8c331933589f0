"""Weight-gradient accumulation ``acc += a^T @ g``, in place: the CUDA
kernel ``csrc/wgrad_accum.cu`` and its wrapper.

The kernel replaces the TPU kernel ``src/repro/kernels/wgrad_accum.py::
wgrad_accum``; the source note in ``csrc/wgrad_accum.cu`` says what bounds it.
:func:`plan_launch` picks one of its three paths by shape and dtype (this
runs on the CPU too, so the tests reach it): ``"wgmma"`` (TMA + wgmma,
Hopper's tensor-core path) for bfloat16 whose rows and bases TMA can
address, ``"mma_sync"`` for other bfloat16 shapes, ``"fma"`` for float32.
It is a dispatch by shape, not a fallback: a launch that fails raises.
:func:`wgrad_accum_cuda` launches on CUDA tensors only and counts each
launch in the module-level integer ``launches`` and, per path, in
``launches_by_path``.
"""

from __future__ import annotations

import ctypes
import functools
import torch

from . import build

__all__ = ["wgrad_accum_cuda", "check_args", "plan_launch", "launches", "launches_by_path",
           "PATHS"]

PATHS = ("wgmma", "mma_sync", "fma")
launches = 0  # kernel launches since the caller last set it to 0
launches_by_path = {p: 0 for p in PATHS}  # the same, per path

_PATH_CODE = {"fma": 0, "mma_sync": 1, "wgmma": 2}
_ERRORS = {-1: "the CUDA driver has no cuTensorMapEncodeTiled",
           -2: "the CUDA driver refused a tensor map"}


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
    if a.dtype not in (torch.float32, torch.bfloat16) or g.dtype != a.dtype:
        raise TypeError(f"wgrad_accum: a={a.dtype} g={g.dtype}; want both float32 or bfloat16")
    if acc.dtype != torch.float32:
        raise TypeError(f"wgrad_accum: acc is {acc.dtype}; the kernel accumulates in float32")
    if not (a.device == g.device == acc.device):
        raise ValueError(f"wgrad_accum: a on {a.device}, g on {g.device}, acc on {acc.device}")
    if not (a.is_contiguous() and g.is_contiguous() and acc.is_contiguous()):
        raise ValueError("wgrad_accum: a, g and acc must be contiguous (call .contiguous() first)")
    if a.numel() == 0 or g.numel() == 0:
        raise ValueError(f"wgrad_accum: empty input a {tuple(a.shape)}, g {tuple(g.shape)}")


def plan_launch(n: int, h: int, f: int, dtype: torch.dtype, a_ptr: int, g_ptr: int,
                acc_ptr: int) -> str:
    """The kernel path of a call with a (N, H), g (N, F) of ``dtype`` and
    acc (H, F) float32 at the given addresses.

    ``"wgmma"`` needs what its TMA tensor maps need: row pitches of a
    multiple of 16 bytes (H and F multiples of 8) and 16-byte aligned bases
    of a, g and acc."""
    if dtype == torch.float32:
        path = "fma"
    elif dtype != torch.bfloat16:
        raise TypeError(f"wgrad_accum: no kernel path for {dtype}")
    elif h % 8 or f % 8 or a_ptr % 16 or g_ptr % 16 or acc_ptr % 16:
        path = "mma_sync"
    else:
        path = "wgmma"
    return path


@functools.lru_cache(maxsize=None)
def _fn():
    f = build.load("wgrad_accum").wgrad_accum
    f.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                  ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    f.restype = ctypes.c_int
    return f


def wgrad_accum_cuda(a: torch.Tensor, g: torch.Tensor, acc: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on CUDA tensors: a (N, H), g (N, F), acc (H, F)
    float32; adds ``a^T @ g`` into ``acc`` in place and returns ``acc``."""
    global launches
    check_args(a, g, acc)
    if a.device.type != "cuda":
        raise ValueError(f"wgrad_accum_cuda: the CUDA kernel needs CUDA tensors, got {a.device}")
    (n, h), f = a.shape, g.shape[1]
    dev = a.device.index
    path = plan_launch(n, h, f, a.dtype, a.data_ptr(), g.data_ptr(), acc.data_ptr())
    args = (a.data_ptr(), g.data_ptr(), acc.data_ptr(), n, h, f, _PATH_CODE[path],
            torch.cuda.current_stream(dev).cuda_stream)
    if dev == torch.cuda.current_device():
        err = _fn()(*args)
    else:  # the launch goes to the calling thread's current device
        with torch.cuda.device(dev):
            err = _fn()(*args)
    if err != 0:
        why = _ERRORS.get(err, f"CUDA error {err}")
        raise RuntimeError(f"wgrad_accum launch failed ({path}): {why} "
                           f"(n={n}, h={h}, f={f})")
    launches += 1
    launches_by_path[path] += 1
    return acc
