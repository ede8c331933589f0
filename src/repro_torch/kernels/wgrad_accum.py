"""Weight-gradient accumulation ``acc += a^T @ g``, in place: the CUDA
kernel ``csrc/wgrad_accum.cu`` and its wrapper.

The kernel replaces the TPU kernel ``src/repro/kernels/wgrad_accum.py::
wgrad_accum``; the source note in ``csrc/wgrad_accum.cu`` says what bounds it.
:func:`plan_launch` picks one of its four paths by shape and dtype (this
runs on the CPU too, so the tests reach it): ``"wgmma"`` (TMA + wgmma,
Hopper's tensor-core path) for bfloat16 whose rows and bases TMA can
address, ``"thin"`` for bfloat16 with a narrow F that is no multiple of 8
(xlstm's mLSTM gate products, F = 4), ``"mma_sync"`` for other bfloat16
shapes, ``"fma"`` for float32.
It is a dispatch by shape, not a fallback: a launch that fails raises.
:func:`wgrad_accum_cuda` launches on CUDA tensors only and counts each
launch in the module-level integer ``launches`` and, per path, in
``launches_by_path``: Python calls, so under a CUDA graph
(``core/executor.py::GraphedGradFn``) they move while the graph is
captured and not when it is replayed.

The ``wgmma`` path encodes its TMA tensor maps on the host from the raw
addresses of a, g and acc at each launch, and passes them by value, so a
captured launch replays with the maps of capture time.  That is right only
while every a, g and acc sits at its captured address.  On the training
path all three are allocated by the captured walk, so the graph's private
memory pool holds them at those addresses on every replay.

The ``fma`` path launches by :func:`plan_fp32` (plain Python, so the tests
reach it): output tiles the narrowest of 16, 32, 64 or 128 columns that
holds F wide, and where those tiles do not fill the card's SMs, N cut
into ``split`` slices of whole steps, one block each, the ``split`` blocks
of a tile forming one thread-block cluster that reduces its partials in
distributed shared memory in rank order.  The plan depends on (N, H, F,
SMs) alone, never on addresses, so a launch and its captured replay sum in
the same order: two launches agree bit for bit
(``tools/wgrad_fp32_variants.py`` times other splits and layouts on the
card).  The ``"thin"`` path launches by :func:`plan_thin`, the same rule
over tiles of ``THIN_TILE_H`` rows of acc, each thread holding all of F
(padded to 4, 8 or 16) for ``THIN_COLS`` of them
(``tools/wgrad_thin_variants.py`` times other splits and layouts).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Tuple

import torch

from . import build
from .rmsnorm import _sms  # the card's SM count, once per device

__all__ = ["wgrad_accum_cuda", "check_args", "plan_launch", "plan_fp32", "Fp32Plan",
           "plan_thin", "ThinPlan", "plan_of", "launches", "launches_by_path", "PATHS"]

PATHS = ("wgmma", "thin", "mma_sync", "fma")
launches = 0  # kernel launches since the caller last set it to 0
launches_by_path = {p: 0 for p in PATHS}  # the same, per path

_PATH_CODE = {"fma": 0, "mma_sync": 1, "wgmma": 2, "thin": 3}
_ERRORS = {-1: "the CUDA driver has no cuTensorMapEncodeTiled",
           -2: "the CUDA driver refused a tensor map"}

# The fp32 plan's constants; csrc/wgrad_accum.cu holds the same numbers.
FP32_TILES_F = (16, 32, 64, 128)  # output columns (F) of a tile, one of these
FP32_TILE_H = {16: 128, 32: 64, 64: 64, 128: 128}  # ... and its rows (H), by width
FP32_BK = {16: 16, 32: 32, 64: 32, 128: 16}  # contraction rows (N) of a ring stage: a step
FP32_SPLITS = (1, 2, 4, 8)        # blocks of a cluster that split N
FP32_STAGES = 4                   # ring stages
_FP32_TM = 8                      # output rows a thread

# The thin plan's constants; csrc/wgrad_accum.cu holds the same numbers.
THIN_TILE_H = 64    # acc rows (H) a tile: 128 bytes of each row of a
THIN_COLS = 8       # H columns a thread: one 16-byte load of a row of a
THIN_THREADS = 256
THIN_BK = THIN_THREADS // (THIN_TILE_H // THIN_COLS)  # rows of N a step
THIN_FS = (4, 8, 16)  # F padded to one of these: the kernel's template widths
THIN_MAX_F = THIN_FS[-1]


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
    of a, g and acc.  ``"thin"`` takes F <= 16 where F is no multiple of 8
    (so wgmma cannot), with rows of a that its threads read 16 bytes at a
    time (H a multiple of 8, a 16-byte aligned): there a tile of 128 x 128
    outputs, mma_sync's, would be at least half padding.  At F = 16 and at
    wider ragged F (wgmma's padding is at most 7 of 128 columns) the other
    paths keep their shapes."""
    if dtype == torch.float32:
        path = "fma"
    elif dtype != torch.bfloat16:
        raise TypeError(f"wgrad_accum: no kernel path for {dtype}")
    elif f % 8 and f <= THIN_MAX_F and h % THIN_COLS == 0 and a_ptr % 16 == 0:
        path = "thin"
    elif h % 8 or f % 8 or a_ptr % 16 or g_ptr % 16 or acc_ptr % 16:
        path = "mma_sync"
    else:
        path = "wgmma"
    return path


@dataclasses.dataclass(frozen=True)
class _ClusterPlan:
    """A launch of the ``fma`` or ``thin`` path: ``tiles`` output tiles of
    ``tile_h`` x ``tile_f``, each computed by a cluster of ``split``
    blocks, block r over the r-th slice of the ``k_steps`` steps of ``bk``
    rows of N."""
    tile_h: int
    tile_f: int
    bk: int
    split: int
    tiles: int
    k_steps: int

    @property
    def grid(self) -> int:
        """Blocks of the launch: the clusters' blocks, tile after tile."""
        return self.tiles * self.split

    def slice(self, rank: int, n: int) -> Tuple[int, int]:
        """Rows [begin, end) of N that block ``rank`` of a cluster sums, as
        the kernel cuts them: steps [rank K / split, (rank + 1) K / split)."""
        s0, s1 = rank * self.k_steps // self.split, (rank + 1) * self.k_steps // self.split
        return min(n, s0 * self.bk), min(n, s1 * self.bk)


def _cluster_split(tiles: int, k_steps: int, sms: int) -> int:
    """1 where the tiles alone fill the card (at least ``sms`` of them),
    else the largest of 2, 4, 8 that the steps of N allow."""
    split = 1
    if tiles < sms:
        while split < FP32_SPLITS[-1] and 2 * split <= k_steps:
            split *= 2
    return split


@dataclasses.dataclass(frozen=True)
class Fp32Plan(_ClusterPlan):
    """The ``fma`` path's launch."""

    @property
    def threads(self) -> int:
        """Threads a block: 8 x 4 outputs each (8 x 8 at 128 columns)."""
        return (self.tile_h // _FP32_TM) * (self.tile_f // (8 if self.tile_f == 128 else 4))

    @property
    def smem_bytes(self) -> int:
        """A block's dynamic shared memory: the ring, whose space then holds
        the block's partial tile."""
        ring = FP32_STAGES * self.bk * (self.tile_h + self.tile_f) * 4
        return max(ring, self.tile_h * self.tile_f * 4)


@dataclasses.dataclass(frozen=True)
class ThinPlan(_ClusterPlan):
    """The ``thin`` path's launch: ``tile_f`` is F padded to 4, 8 or 16."""

    @property
    def threads(self) -> int:
        """Threads a block: ``THIN_COLS`` columns of H by all of F each."""
        return THIN_THREADS

    @property
    def smem_bytes(self) -> int:
        """A block's static shared memory: each warp's partial tile, then
        the block's, which the cluster reads."""
        return (THIN_THREADS // 32 + 1) * self.tile_h * self.tile_f * 4


@functools.lru_cache(maxsize=4096)
def plan_fp32(n: int, h: int, f: int, sms: int) -> Fp32Plan:
    """The ``fma`` launch of a (N, H), g (N, F), acc (H, F) on a card of
    ``sms`` SMs.

    The tile is the narrowest of 16, 32, 64, 128 columns that holds F (128
    past that), by 64 rows at 32 and 64 columns and 128 rows at 16 and 128,
    whose steps are 32 and 16 rows of N (``FP32_TILE_H``, ``FP32_BK``).
    The split is 1 where the tiles alone fill the card (at least ``sms`` of
    them), else the largest of 2, 4, 8 that the steps of N allow: the
    routers' N = 1024 runs as 8 slices of 128, which also keeps each
    output's fp32 runs short (an fp64-exact sum is within ~1e-5 of it,
    where one run of 1024 was 4.6e-5 off)."""
    tile_f = next((t for t in FP32_TILES_F if t >= f), FP32_TILES_F[-1])
    tile_h, bk = FP32_TILE_H[tile_f], FP32_BK[tile_f]
    tiles = -(-h // tile_h) * -(-f // tile_f)
    k_steps = -(-n // bk)
    return Fp32Plan(tile_h, tile_f, bk, _cluster_split(tiles, k_steps, sms), tiles, k_steps)


@functools.lru_cache(maxsize=4096)
def plan_thin(n: int, h: int, f: int, sms: int) -> ThinPlan:
    """The ``thin`` launch of a (N, H), g (N, F <= 16), acc (H, F) on a card
    of ``sms`` SMs: tiles of ``THIN_TILE_H`` rows of acc by all of F (padded
    to 4, 8 or 16), steps of ``THIN_BK`` rows of N, and the ``fma`` plan's
    split rule.  xlstm's gate products (N = 2048, H = 1024, F = 4) run as
    16 tiles x 8 = 128 blocks, each over 256 rows of N."""
    if not 1 <= f <= THIN_MAX_F:
        raise ValueError(f"wgrad_accum: the thin path takes F <= {THIN_MAX_F}, not {f}")
    tile_f = next(t for t in THIN_FS if t >= f)
    tiles = -(-h // THIN_TILE_H)
    k_steps = -(-n // THIN_BK)
    return ThinPlan(THIN_TILE_H, tile_f, THIN_BK, _cluster_split(tiles, k_steps, sms), tiles,
                    k_steps)


def plan_of(path: str, n: int, h: int, f: int, sms: int):
    """The cluster plan a path launches by (``fma``, ``thin``), else None."""
    if path == "fma":
        return plan_fp32(n, h, f, sms)
    if path == "thin":
        return plan_thin(n, h, f, sms)
    return None


@functools.lru_cache(maxsize=None)
def _fn():
    f = build.load("wgrad_accum").wgrad_accum
    f.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                  ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                  ctypes.c_int, ctypes.c_void_p]
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
    plan = plan_of(path, n, h, f, _sms(dev))
    tile_f, split = (plan.tile_f, plan.split) if plan is not None else (0, 0)
    args = (a.data_ptr(), g.data_ptr(), acc.data_ptr(), n, h, f, _PATH_CODE[path], tile_f,
            split, torch.cuda.current_stream(dev).cuda_stream)
    if dev == torch.cuda.current_device():
        err = _fn()(*args)
    else:  # the launch goes to the calling thread's current device
        with torch.cuda.device(dev):
            err = _fn()(*args)
    if err != 0:
        why = _ERRORS.get(err, f"CUDA error {err}")
        raise RuntimeError(f"wgrad_accum launch failed ({path}, {plan}): {why} "
                           f"(n={n}, h={h}, f={f})")
    launches += 1
    launches_by_path[path] += 1
    return acc
