"""The sLSTM time loop: the CUDA kernel ``csrc/slstm_scan.cu`` and its wrapper.

The kernel replaces no TPU kernel: the JAX package runs the loop of
``src/repro/models/modules.py::apply_slstm`` as a ``lax.scan``.  It is a
kernel of the port because the loop, s steps of elementwise work, would be
~40 launches a step as PyTorch ops; the note in the source says what bounds
it.  :class:`SLSTMScan` is its ``torch.autograd.Function``: the forward
kernel (``"fwd"``) returns h and the state after every step, of which the
last step's (c, n, m) is what a prefill keeps; the backward kernel
(``"bwd"``) walks the steps in reverse from the saved states.  Both launch on
CUDA tensors only and count each launch in the module-level integer
``launches`` and, per kernel, in ``launches_by_path``; a launch that fails
raises.  The plain version is ``kernels/ref.py::slstm_scan_ref``.

The kernels run a block for each ``CHANNELS`` channels of a batch row,
the steps in chunks of ``CHUNK`` through a ring of ``FWD_RING`` /
``BWD_RING`` chunks in shared memory, with two warps on the loop-carried
chains and the rest of the block's ``WARPS`` warps on everything else (the
note in the source); these constants are the source's, and :func:`grid`
is its launch (``tools/slstm_variants.py`` times other values).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build, is_fake

__all__ = ["SLSTMScan", "check_args", "forward", "backward", "grid", "launches",
           "launches_by_path", "PATHS", "CHANNELS", "CHUNK", "FWD_RING", "BWD_RING", "WARPS"]

PATHS = ("fwd", "bwd")
launches = 0  # kernel launches since the caller last set it to 0
launches_by_path = {p: 0 for p in PATHS}  # the same, per kernel

# The kernels' layout; csrc/slstm_scan.cu holds the same numbers.
CHANNELS = 8   # channels a block: 32 bytes of a step of each array
CHUNK = 64     # steps a chunk: one tick of the block's pipeline
FWD_RING = 12  # chunk slots of the forward's ring in shared memory
BWD_RING = 8   # ... and of the backward's
WARPS = 16     # warps a block: two chains, two groups of workers


def grid(b: int, h: int) -> int:
    """Blocks of a launch at (b, s, h): one each ``CHANNELS`` channels of a
    batch row."""
    return b * -(-h // CHANNELS)


def check_args(i_pre: torch.Tensor, f_pre: torch.Tensor, z: torch.Tensor) -> None:
    """Raise on what the kernel does not take (both devices check alike):
    three float32 (b, s, h) tensors, contiguous, on one device."""
    for name, t in (("i_pre", i_pre), ("f_pre", f_pre), ("z", z)):
        if t.dim() != 3 or tuple(t.shape) != tuple(i_pre.shape):
            raise ValueError(f"slstm_scan: {name} shape {tuple(t.shape)}; want (b, s, h) "
                             f"like i_pre's {tuple(i_pre.shape)}")
        if t.dtype != torch.float32:
            raise TypeError(f"slstm_scan: {name} is {t.dtype}; want float32")
        if t.device != i_pre.device:
            raise ValueError(f"slstm_scan: {name} on {t.device}, i_pre on {i_pre.device}")
        if not t.is_contiguous():
            raise ValueError(f"slstm_scan: {name} must be contiguous (call .contiguous() first)")
    if i_pre.numel() == 0:
        raise ValueError(f"slstm_scan: empty input {tuple(i_pre.shape)}")


@functools.lru_cache(maxsize=None)
def _fns():
    lib = build.load("slstm_scan")
    fwd, bwd = lib.slstm_fwd, lib.slstm_bwd
    fwd.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    bwd.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fwd.restype = bwd.restype = ctypes.c_int
    return fwd, bwd


def _launch(path: str, tensors, shape) -> None:
    global launches
    dev = tensors[0].device.index
    fn = _fns()[PATHS.index(path)]
    args = (*(t.data_ptr() for t in tensors), *shape,
            torch.cuda.current_stream(dev).cuda_stream)
    if dev == torch.cuda.current_device():
        err = fn(*args)
    else:  # the launch goes to the calling thread's current device
        with torch.cuda.device(dev):
            err = fn(*args)
    if err != 0:
        raise RuntimeError(f"slstm_{path} launch failed: CUDA error {err} (b, s, h = {shape})")
    launches += 1
    launches_by_path[path] += 1


def forward(i_pre: torch.Tensor, f_pre: torch.Tensor, z: torch.Tensor):
    """Launch the forward kernel: -> (h, c, n, m), each (b, s, h) fp32, the
    output and the state after every step.  On fake tensors (the dry run)
    it returns the outputs unwritten and launches nothing."""
    check_args(i_pre, f_pre, z)
    fake = is_fake(i_pre)
    if not fake and i_pre.device.type != "cuda":
        raise ValueError(f"slstm_scan: the CUDA kernel needs CUDA tensors, got {i_pre.device}")
    outs = [torch.empty_like(i_pre) for _ in range(4)]
    if not fake:
        _launch("fwd", (i_pre, f_pre, z, *outs), tuple(i_pre.shape))
    return tuple(outs)


def backward(i_pre, f_pre, z, c, n, m, dh):
    """Launch the backward kernel on the forward's inputs and states and the
    gradient of h: -> (d i_pre, d f_pre, d z), each (b, s, h) fp32."""
    dh = dh.contiguous()
    for t in (c, n, m, dh):
        if t.shape != i_pre.shape or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"slstm_scan backward: a state or gradient of shape "
                             f"{tuple(t.shape)} {t.dtype}; want {tuple(i_pre.shape)} float32, "
                             f"contiguous")
    outs = [torch.empty_like(i_pre) for _ in range(3)]
    if not is_fake(i_pre):  # a fake tensor launches nothing
        _launch("bwd", (i_pre, f_pre, z, c, n, m, dh, *outs), tuple(i_pre.shape))
    return tuple(outs)


class SLSTMScan(torch.autograd.Function):
    """(i_pre, f_pre, z) -> (h, c, n, m): h (b, s, h) and the final state
    (b, h), which carries no gradient (a prefill keeps it)."""

    @staticmethod
    def forward(ctx, i_pre, f_pre, z):
        hs, c, n, m = forward(i_pre, f_pre, z)
        ctx.save_for_backward(i_pre, f_pre, z, c, n, m)
        last = tuple(t[:, -1].clone() for t in (c, n, m))
        ctx.mark_non_differentiable(*last)
        return (hs, *last)

    @staticmethod
    def backward(ctx, dh, *_):
        return backward(*ctx.saved_tensors, dh)
