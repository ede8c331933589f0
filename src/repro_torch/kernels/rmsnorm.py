"""RMSNorm forward: the CUDA kernel ``csrc/rmsnorm.cu`` and its wrapper.

The kernel replaces the TPU kernel ``src/repro/kernels/rmsnorm.py::
rmsnorm_fused``; the source note in ``csrc/rmsnorm.cu`` says what bounds it.
:func:`plan_launch` picks one of its three paths by shape and alignment
(this runs on the CPU too, so the tests reach it): ``"bulk"`` (rows staged
in shared memory by bulk async copies, a persistent grid) for 16-byte
aligned rows at more rows than SMs, ``"latency"`` (one block a row, the row
held in registers) for the same alignment at a few rows, ``"rowwise"`` for
everything else.  It is a dispatch by shape, not a fallback: a launch that
fails raises.  :func:`rmsnorm_fused` launches on CUDA tensors only and
counts each launch in the module-level integer ``launches`` and, per path,
in ``launches_by_path``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from . import build

__all__ = ["rmsnorm_fused", "launch", "check_args", "plan_launch", "bulk_plan", "Plan",
           "launches", "launches_by_path", "PATHS", "MAX_BLOCKS_PER_SM", "SMEM_PER_BLOCK"]

PATHS = ("bulk", "latency", "rowwise")
launches = 0  # kernel launches since the caller last set it to 0
launches_by_path = {p: 0 for p in PATHS}  # the same, per path

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_PATH_CODE = {"rowwise": 0, "latency": 1, "bulk": 2}

# The plan's constants; csrc/rmsnorm.cu holds the same numbers.
MAX_BLOCKS_PER_SM = 2      # bulk: persistent blocks an SM, at most
SMEM_PER_BLOCK = 232448    # 227 KB: the most shared memory a block may use
_SMEM_PER_SM = 233472      # 228 KB an SM, of which each block's runtime keeps 1 KB
_CONSUMER_WARPS = 8        # bulk: warps that reduce and store (+1 producer warp)
_WARP_ROW_BYTES = 4608     # bulk: one warp owns a row up to this many bytes
_STAGE_MIN_BYTES = 4096    # bulk: a ring stage holds whole rows, this many bytes or more
_MAX_STAGES = 16           # bulk: ring stages, at most
_LATENCY_MAX_H = 8192      # latency: widest row held in registers


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


@dataclasses.dataclass(frozen=True)
class Plan:
    """One launch: the path and its grid; for ``"bulk"`` also the rows a
    ring stage holds, the warps that own a row, the ring's stages and the
    block's dynamic shared memory in bytes."""
    path: str
    grid: int
    rows: int = 0
    warps_per_row: int = 0
    stages: int = 0
    smem_bytes: int = 0


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def _bulk_smem(h: int, row_bytes: int, rows: int, stages: int) -> int:
    """The bulk block's shared memory, as ``csrc/rmsnorm.cu::bulk_smem``:
    the ring (128-byte aligned stages), (1 + g) in fp32, two mbarriers a
    stage, two sets of the consumer warps' partial sums."""
    return (stages * _round_up(rows * row_bytes, 128) + _round_up(4 * h, 16) + 16 * stages
            + 2 * _CONSUMER_WARPS * 4)


def bulk_plan(n: int, h: int, x_size: int, sms: int, per_sm: int,
              max_stages: int = _MAX_STAGES, warps_per_row: int = 0):
    """The ``"bulk"`` launch of N rows of H elements of ``x_size`` bytes with
    ``per_sm`` blocks an SM and at most ``max_stages`` ring stages, or None
    where the ring does not fit that many blocks an SM.

    The warps a row (a power of two up to 8, unless ``warps_per_row`` names
    them) are the fewest whose share of a row is at most 4608 bytes, and
    more where a block has fewer tiles than groups of warps: a block's tiles
    then all run at once, each on more warps (at 1024 rows of 2048 or 2304
    in bf16, two warps a row beat one on the H100).  The stages are a
    multiple of the consumer groups (8 warps over the warps a row), at least
    two: group q takes a block's tiles q, q + groups, ..., so each stage
    serves one group in every round."""
    row_bytes = h * x_size
    rows = max(1, _STAGE_MIN_BYTES // row_bytes)
    tiles = -(-n // rows)
    grid = min(tiles, per_sm * sms)
    per_block = -(-tiles // grid)
    wpr = warps_per_row or 1
    while not warps_per_row and wpr < _CONSUMER_WARPS and (
            wpr * _WARP_ROW_BYTES < row_bytes or _CONSUMER_WARPS // (2 * wpr) >= per_block):
        wpr *= 2
    groups = _CONSUMER_WARPS // wpr
    budget = min(SMEM_PER_BLOCK, _SMEM_PER_SM // per_sm - 1024)
    fixed = _bulk_smem(h, row_bytes, rows, 0)
    stages = min(max_stages, (budget - fixed) // (_round_up(rows * row_bytes, 128) + 16))
    stages -= stages % groups
    if stages < max(2, groups):
        return None
    return Plan("bulk", grid, rows, wpr, stages, _bulk_smem(h, row_bytes, rows, stages))


@functools.lru_cache(maxsize=4096)
def _plan(n: int, h: int, x_size: int, aligned: bool, sms: int) -> Plan:
    row_bytes = h * x_size
    if not aligned or row_bytes % 16:
        return Plan("rowwise", n)
    if n <= sms and h <= _LATENCY_MAX_H:
        return Plan("latency", n)
    for per_sm in range(MAX_BLOCKS_PER_SM, 0, -1):  # two blocks an SM where two fit
        plan = bulk_plan(n, h, x_size, sms, per_sm)
        if plan is not None:
            return plan
    return Plan("rowwise", n)  # a row too wide for a ring of two stages


def plan_launch(n: int, h: int, x_dtype: torch.dtype, g_dtype: torch.dtype, x_ptr: int,
                y_ptr: int, sms: int) -> Plan:
    """The kernel launch for N rows of H, x of ``x_dtype`` at ``x_ptr``, y at
    ``y_ptr``, g of ``g_dtype``, on a card with ``sms`` SMs.

    ``"bulk"`` and ``"latency"`` read x and write y in 16-byte vectors, so
    they need 16-byte aligned x and y and rows of a multiple of 16 bytes;
    ``"latency"`` takes at most ``sms`` rows of H <= 8192, ``"bulk"`` the
    rest whose ring of two stages fits a block's shared memory."""
    if x_dtype not in _DTYPE_CODE or g_dtype not in _DTYPE_CODE:
        raise TypeError(f"rmsnorm: no kernel path for x={x_dtype} g={g_dtype}")
    x_size = torch.tensor([], dtype=x_dtype).element_size()
    return _plan(n, h, x_size, x_ptr % 16 == 0 and y_ptr % 16 == 0, sms)


@functools.lru_cache(maxsize=None)
def _sms(dev: int) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


@functools.lru_cache(maxsize=None)
def _fn():
    f = build.load("rmsnorm").rmsnorm_fwd
    f.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                  ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
                  ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                  ctypes.c_void_p]
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
    plan = plan_launch(n, h, x.dtype, g.dtype, x.data_ptr(), y.data_ptr(), _sms(x.device.index))
    launch(x, g, y, eps, plan)
    launches += 1
    launches_by_path[plan.path] += 1
    return y


def launch(x: torch.Tensor, g: torch.Tensor, y: torch.Tensor, eps: float, plan: Plan) -> None:
    """Launch ``plan`` on CUDA tensors x (N, H) -> y; counts nothing.  Raises
    if the launch fails, or if the kernel refuses the plan for these tensors."""
    h = x.shape[-1]
    n = x.numel() // h
    dev = x.device.index
    args = (x.data_ptr(), g.data_ptr(), y.data_ptr(), n, h,
            _DTYPE_CODE[x.dtype], _DTYPE_CODE[g.dtype], eps, _PATH_CODE[plan.path], plan.grid,
            plan.rows, plan.warps_per_row, plan.stages, plan.smem_bytes,
            torch.cuda.current_stream(dev).cuda_stream)
    if dev == torch.cuda.current_device():
        err = _fn()(*args)
    else:  # the launch goes to the calling thread's current device
        with torch.cuda.device(dev):
            err = _fn()(*args)
    if err != 0:
        raise RuntimeError(f"rmsnorm_fwd launch failed ({plan.path}): CUDA error {err} "
                           f"(n={n}, h={h})")
