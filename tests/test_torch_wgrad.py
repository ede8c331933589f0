"""The port's weight-gradient accumulation and RMSNorm backward against the
JAX package.

* The plain ``wgrad_accum_ref`` (the CPU path of ``repro_torch.kernels.ops``)
  against the JAX oracle ``wgrad_accum_ref`` and the Pallas kernel
  ``wgrad_accum`` in interpret mode, over the JAX package's ``WGRAD_SHAPES``
  in float32 and bfloat16, plus ragged shapes (the reduced config's 48 x 96
  weights) against the JAX oracle.  Tolerances are those of
  ``tests/test_kernels.py``: 1e-5 in float32 (other summation orders over
  N <= 1024 terms), 2e-2 for bfloat16 inputs (the repo's bf16 kernel
  tolerance).  One exception, measured: at N = 1024 in float32 the JAX
  package's own oracle and its Pallas kernel differ by up to 1.7e-5 on
  these inputs (the oracle sums the 1024 products in one pass, the kernel
  in two blocks of 512; against a float64 product their errors are 1.6e-5
  and 6.8e-6), so the plain version -- which agrees with the oracle to
  4e-6 -- is held to the Pallas kernel at 2e-5 in float32.
* ``ops.wgrad_accum`` adds into its accumulator in place and returns it.
* The wrapper refuses what the CUDA kernel would refuse, on the CPU too, and
  ``plan_launch`` picks the kernel path (wgmma / thin / mma_sync / fma) by
  shape, dtype and alignment, without a card: xlstm's mLSTM gate products
  (F = 4) take ``thin`` in bf16 and ``fma`` in the reduced f32 models.
* ``plan_fp32``, the fp32 path's launch plan, at the routers' shapes, the
  square fp32 shape, the reduced model's and a ragged one, on 132 SMs: the
  tile width follows F, the split is 1, 2, 4 or 8 (1 where the tiles fill
  the card), the slices of N cover it once, the grid, block and shared
  memory stay within CUDA's limits, the plan reads no address, and its
  constants are those compiled into ``csrc/wgrad_accum.cu``.
* ``plan_thin``, the thin path's plan, at xlstm's gate shapes (N = 2048 and
  1024) and two ragged ones, alike: F padded to 4, 8 or 16, the fma plan's
  split rule, N's slices covered once, CUDA's grid, cluster and static
  shared-memory limits, no address read, constants = the .cu's.
* The RMSNorm ``autograd.Function`` backward against the JAX ``_rms_bwd``
  and against ``jax.grad`` of ``modules.rmsnorm`` (f32, 1e-5: one rsqrt and
  a few sums in another order).
* The CUDA kernel itself runs only on the card: the ``cuda``-marked cases
  skip here, and ``chip_smoke.py`` holds the kernel against the plain
  version on the H100 at the training path's shapes.
"""

import inspect
import re

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.ops import _rms_bwd as jax_rms_bwd  # noqa: E402
from repro.kernels.ref import wgrad_accum_ref as jax_wgrad_ref  # noqa: E402
from repro.kernels.wgrad_accum import wgrad_accum as jax_wgrad_pallas  # noqa: E402
from repro.models import modules as jmod  # noqa: E402

from repro_torch.interop import to_torch  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import wgrad_accum as twg  # noqa: E402
from repro_torch.kernels.ref import rmsnorm_bwd_ref, wgrad_accum_ref  # noqa: E402

# (n, h, f, bn, bh, bf) of tests/test_kernels.py
WGRAD_SHAPES = [
    (256, 128, 128, 64, 64, 128),
    (512, 256, 128, 128, 128, 128),
    (128, 128, 512, 128, 128, 128),
    (1024, 128, 256, 512, 128, 128),
]
RAGGED = [(32, 48, 96), (32, 96, 48), (77, 129, 257), (1, 3, 5),
          (2048, 1024, 4), (77, 136, 5)]  # the last two: the thin path's shapes
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
PALLAS_F32_TOL = 2e-5  # the JAX oracle's own distance to its Pallas kernel (see above)


def _inputs(n, h, f, dtype, seed=0):
    rng = np.random.default_rng(seed)
    a = jnp.asarray(rng.standard_normal((n, h)) * 0.5, dtype=dtype)
    g = jnp.asarray(rng.standard_normal((n, f)) * 0.5, dtype=dtype)
    acc = jnp.asarray(rng.standard_normal((h, f)) * 0.5, dtype=jnp.float32)
    return a, g, acc


def _t(x):
    return to_torch(np.asarray(x))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,h,f,bn,bh,bf", WGRAD_SHAPES)
def test_plain_wgrad_matches_jax(n, h, f, bn, bh, bf, dtype):
    a, g, acc = _inputs(n, h, f, dtype)
    got = ops.wgrad_accum(_t(a), _t(g), _t(acc))
    assert got.dtype == torch.float32 and got.shape == (h, f)
    tol = TOL[dtype]
    pallas_tol = PALLAS_F32_TOL if dtype == "float32" else tol
    for want, t in ((jax_wgrad_ref(a, g, acc), tol),
                    (jax_wgrad_pallas(a, g, acc, bh=bh, bf=bf, bn=bn, interpret=True), pallas_tol)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32), rtol=t, atol=t)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,h,f", RAGGED)
def test_plain_wgrad_ragged_matches_jax(n, h, f, dtype):
    a, g, acc = _inputs(n, h, f, dtype, seed=1)
    got = ops.wgrad_accum(_t(a), _t(g), _t(acc))
    tol = TOL[dtype]
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_wgrad_ref(a, g, acc), np.float32),
                               rtol=tol, atol=tol)


def test_wgrad_accumulates_in_place():
    a, g, acc = _inputs(64, 48, 96, "float32", seed=2)
    acc_t = _t(acc)
    ptr = acc_t.data_ptr()
    out = ops.wgrad_accum(_t(a), _t(g), acc_t)
    assert out is acc_t and out.data_ptr() == ptr
    np.testing.assert_allclose(acc_t.numpy(), np.asarray(jax_wgrad_ref(a, g, acc), np.float32),
                               rtol=TOL["float32"], atol=TOL["float32"])


@pytest.mark.parametrize(
    "n,h,f,dtype,offsets,want",
    [
        # the four W products of the training step (N = 1024 tokens)
        (1024, 2048, 2048, torch.bfloat16, (0, 0, 0), "wgmma"),  # wq, wo
        (1024, 2048, 1024, torch.bfloat16, (0, 0, 0), "wgmma"),  # wk, wv
        (1024, 2048, 8192, torch.bfloat16, (0, 0, 0), "wgmma"),  # wu, wg
        (1024, 8192, 2048, torch.bfloat16, (0, 0, 0), "wgmma"),  # wd
        (1000, 2048, 2048, torch.bfloat16, (0, 0, 0), "wgmma"),  # ragged N
        (40, 200, 296, torch.bfloat16, (0, 0, 0), "wgmma"),  # ragged everywhere
        (1000, 200, 300, torch.bfloat16, (0, 0, 0), "mma_sync"),  # F % 8 != 0
        (1000, 204, 304, torch.bfloat16, (0, 0, 0), "mma_sync"),  # H % 8 != 0
        (1024, 2048, 2048, torch.bfloat16, (2, 0, 0), "mma_sync"),  # a misaligned
        (1024, 2048, 2048, torch.bfloat16, (0, 2, 0), "mma_sync"),  # g misaligned
        (1024, 2048, 2048, torch.bfloat16, (0, 0, 4), "mma_sync"),  # acc misaligned
        (1024, 2048, 2048, torch.float32, (0, 0, 0), "fma"),
        (32, 48, 96, torch.float32, (4, 4, 4), "fma"),
        # xlstm's mLSTM gate products mfg, mig: F = n_heads = 4
        (2048, 1024, 4, torch.bfloat16, (0, 0, 0), "thin"),
        (1024, 1024, 4, torch.bfloat16, (0, 0, 0), "thin"),
        (2048, 1024, 4, torch.bfloat16, (0, 2, 4), "thin"),  # g, acc alignment not needed
        (2048, 1024, 4, torch.float32, (0, 0, 0), "fma"),  # the reduced f32 models
        (1000, 200, 12, torch.bfloat16, (0, 0, 0), "thin"),
        (77, 136, 5, torch.bfloat16, (0, 0, 0), "thin"),
        (2048, 1024, 4, torch.bfloat16, (2, 0, 0), "mma_sync"),  # a misaligned
        (2048, 1020, 4, torch.bfloat16, (0, 0, 0), "mma_sync"),  # H % 8 != 0
        (2048, 1024, 16, torch.bfloat16, (0, 0, 0), "wgmma"),  # F % 8 == 0
        (2048, 1024, 20, torch.bfloat16, (0, 0, 0), "mma_sync"),  # wider than the thin path
    ],
)
def test_plan_launch_picks_path_and_tile(n, h, f, dtype, offsets, want):
    base = 1 << 20
    ptrs = [base + o for o in offsets]
    assert twg.plan_launch(n, h, f, dtype, *ptrs) == want


def test_plan_launch_sees_a_misaligned_view():
    a = torch.zeros(64 * 128 + 1, dtype=torch.bfloat16)[1:].view(64, 128)  # 2 bytes past a line
    g, acc = torch.zeros(64, 256, dtype=torch.bfloat16), torch.zeros(128, 256)
    assert a.is_contiguous() and a.data_ptr() % 16 == 2
    got = twg.plan_launch(64, 128, 256, a.dtype, a.data_ptr(), g.data_ptr(), acc.data_ptr())
    assert got == "mma_sync"
    ops.wgrad_accum(a, g, acc)  # the plain path takes it all the same


def test_plan_launch_refuses_other_dtypes():
    with pytest.raises(TypeError):
        twg.plan_launch(8, 8, 8, torch.float16, 0, 0, 0)


@pytest.mark.parametrize(
    "a,g,acc,err",
    [
        (torch.zeros(4, 3), torch.zeros(5, 2), torch.zeros(3, 2), ValueError),  # N differs
        (torch.zeros(4, 3), torch.zeros(4, 2), torch.zeros(2, 3), ValueError),  # acc transposed
        (torch.zeros(4, 3), torch.zeros(4, 2), torch.zeros(3, 2, dtype=torch.bfloat16), TypeError),
        (torch.zeros(4, 3), torch.zeros(4, 2, dtype=torch.bfloat16), torch.zeros(3, 2), TypeError),
        (torch.zeros(4, 3, dtype=torch.float16), torch.zeros(4, 2, dtype=torch.float16),
         torch.zeros(3, 2), TypeError),
        (torch.zeros(3, 4).t(), torch.zeros(4, 2), torch.zeros(3, 2), ValueError),  # a strided
        (torch.zeros(4, 3, 1), torch.zeros(4, 2), torch.zeros(3, 2), ValueError),  # rank 3
        (torch.zeros(0, 3), torch.zeros(0, 2), torch.zeros(3, 2), ValueError),  # empty
    ],
)
def test_wrapper_refuses_what_the_kernel_does_not_take(a, g, acc, err):
    with pytest.raises(err):
        ops.wgrad_accum(a, g, acc)


SMS = 132  # an H100 SXM's SMs
# (n, h, f) of chip_smoke.py phase 3's fp32 shapes, and the tile width each takes
FP32_SHAPES = {
    "qwen2-moe router": ((1024, 2048, 60), 64),
    "deepseek router": ((1024, 7168, 16), 16),
    "fp32": ((1024, 2048, 2048), 128),
    "reduced": ((64, 48, 96), 128),
    "ragged-fp32": ((77, 129, 257), 128),
}


@pytest.mark.parametrize("label", list(FP32_SHAPES))
def test_plan_fp32_tile_follows_f(label):
    (n, h, f), want = FP32_SHAPES[label]
    plan = twg.plan_fp32(n, h, f, SMS)
    assert plan.tile_f == want
    assert (plan.tile_h, plan.bk) == (twg.FP32_TILE_H[want], twg.FP32_BK[want])
    # the narrowest tile that holds F: the next narrower one would not
    assert plan.tile_f >= f or plan.tile_f == twg.FP32_TILES_F[-1]
    narrower = [t for t in twg.FP32_TILES_F if t < plan.tile_f]
    assert not narrower or narrower[-1] < f
    assert plan.tiles == -(-h // plan.tile_h) * -(-f // plan.tile_f)


@pytest.mark.parametrize("label", list(FP32_SHAPES))
def test_plan_fp32_splits_n_only_where_the_tiles_do_not_fill(label):
    (n, h, f), _ = FP32_SHAPES[label]
    plan = twg.plan_fp32(n, h, f, SMS)
    assert plan.split in twg.FP32_SPLITS
    if plan.tiles >= SMS:
        assert plan.split == 1
    else:  # as many slices as the 16-row steps of N allow, up to 8
        assert plan.split == min(8, 1 << (plan.k_steps.bit_length() - 1))
    want = {"qwen2-moe router": 8, "deepseek router": 8, "fp32": 1, "reduced": 4,
            "ragged-fp32": 4}[label]
    assert plan.split == want


@pytest.mark.parametrize("label", list(FP32_SHAPES))
def test_plan_fp32_slices_cover_n_once(label):
    (n, h, f), _ = FP32_SHAPES[label]
    plan = twg.plan_fp32(n, h, f, SMS)
    assert plan.k_steps == -(-n // plan.bk)
    slices = [plan.slice(r, n) for r in range(plan.split)]
    assert slices[0][0] == 0 and slices[-1][1] == n
    for (b0, e0), (b1, _) in zip(slices, slices[1:]):
        assert e0 == b1  # contiguous: no row twice, none left out
    for b, e in slices:
        assert b < e and b % plan.bk == 0  # whole steps, none empty
    if (n, label) == (1024, "qwen2-moe router") or label == "deepseek router":
        assert slices == [(128 * r, 128 * (r + 1)) for r in range(8)]


@pytest.mark.parametrize("label", list(FP32_SHAPES))
def test_plan_fp32_launch_stays_within_cuda_limits(label):
    (n, h, f), _ = FP32_SHAPES[label]
    plan = twg.plan_fp32(n, h, f, SMS)
    assert plan.grid == plan.tiles * plan.split and 1 <= plan.grid <= 2**31 - 1
    assert plan.grid % plan.split == 0  # whole clusters
    assert plan.split <= 8  # the portable cluster size
    assert 32 <= plan.threads <= 1024 and plan.threads % 32 == 0
    assert plan.smem_bytes <= 232448  # 227 KB, the most a block may opt into
    # the partial tile fits the ring's space, and each block of a cluster
    # reduces a whole number of its rows
    assert plan.tile_h * plan.tile_f * 4 <= plan.smem_bytes
    assert plan.tile_h % plan.split == 0


def test_plan_fp32_reads_no_address():
    assert list(inspect.signature(twg.plan_fp32).parameters) == ["n", "h", "f", "sms"]
    for offsets in ((0, 0, 0), (4, 4, 4), (4, 0, 8)):
        base = 1 << 20
        assert twg.plan_launch(1024, 2048, 60, torch.float32,
                               *(base + o for o in offsets)) == "fma"
    # the same shapes plan alike on every call, and the plan is a value
    assert twg.plan_fp32(1024, 2048, 60, SMS) == twg.plan_fp32(1024, 2048, 60, SMS)
    assert hash(twg.plan_fp32(1024, 7168, 16, SMS)) == hash(twg.Fp32Plan(128, 16, 16, 8, 56, 64))


def test_plan_fp32_constants_match_the_kernel_source():
    src = (build.CSRC / "wgrad_accum.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    def table(name):
        body = re.search(rf"constexpr int {name}\[4\] = \{{([\d, ]+)\}};", src).group(1)
        return tuple(int(v) for v in body.split(","))

    widths = table("kF32Widths")
    assert widths == twg.FP32_TILES_F
    assert dict(zip(widths, table("kF32TileHs"))) == twg.FP32_TILE_H
    assert dict(zip(widths, table("kF32BKs"))) == twg.FP32_BK
    assert const("kF32Stages") == twg.FP32_STAGES
    assert const("kF32MaxSplit") == twg.FP32_SPLITS[-1]
    for tile_f in twg.FP32_TILES_F:  # every tile width has its two launches
        assert f"launch_f32_as<{tile_f}, true>" in src and f"launch_f32_as<{tile_f}, false>" in src


# (n, h, f) of the thin path's shapes, and F padded
THIN_SHAPES = {
    "xlstm mfg,mig": ((2048, 1024, 4), 4),
    "N=1024": ((1024, 1024, 4), 4),
    "F=12": ((1000, 200, 12), 16),
    "F=5": ((77, 136, 5), 8),
}


@pytest.mark.parametrize("label", list(THIN_SHAPES))
def test_plan_thin_tile_and_split(label):
    (n, h, f), want = THIN_SHAPES[label]
    plan = twg.plan_thin(n, h, f, SMS)
    assert (plan.tile_h, plan.tile_f, plan.bk) == (twg.THIN_TILE_H, want, twg.THIN_BK)
    assert plan.tiles == -(-h // twg.THIN_TILE_H) and plan.k_steps == -(-n // twg.THIN_BK)
    # the fma plan's rule: 1 where the tiles fill the card, else as many
    # slices as the steps allow, up to 8
    assert plan.split == (1 if plan.tiles >= SMS
                          else min(8, 1 << (plan.k_steps.bit_length() - 1)))
    want_split = {"xlstm mfg,mig": 8, "N=1024": 8, "F=12": 8, "F=5": 2}[label]
    assert plan.split == want_split
    if label == "xlstm mfg,mig":  # 16 tiles x 8: all but 4 of the SMs, one block each
        assert (plan.tiles, plan.grid) == (16, 128)


@pytest.mark.parametrize("label", list(THIN_SHAPES))
def test_plan_thin_slices_cover_n_once(label):
    (n, h, f), _ = THIN_SHAPES[label]
    plan = twg.plan_thin(n, h, f, SMS)
    slices = [plan.slice(r, n) for r in range(plan.split)]
    assert slices[0][0] == 0 and slices[-1][1] == n
    for (_, e0), (b1, _) in zip(slices, slices[1:]):
        assert e0 == b1
    for b, e in slices:
        assert b < e and b % plan.bk == 0
    if label == "xlstm mfg,mig":
        assert slices == [(256 * r, 256 * (r + 1)) for r in range(8)]


@pytest.mark.parametrize("label", list(THIN_SHAPES))
def test_plan_thin_launch_stays_within_cuda_limits(label):
    (n, h, f), _ = THIN_SHAPES[label]
    plan = twg.plan_thin(n, h, f, SMS)
    assert 1 <= plan.grid <= 2**31 - 1 and plan.grid % plan.split == 0
    assert plan.split in twg.FP32_SPLITS and plan.split <= 8  # the portable cluster size
    assert 32 <= plan.threads <= 1024 and plan.threads % 32 == 0
    assert plan.smem_bytes <= 48 * 1024  # static shared memory
    # each block of a cluster adds a whole number of the tile's float4s
    assert (plan.tile_h * plan.tile_f // 4) % plan.split == 0
    # a thread's columns of a row are one aligned load, wholly in or out of H
    assert h % twg.THIN_COLS == 0 and twg.THIN_TILE_H % twg.THIN_COLS == 0


def test_plan_thin_reads_no_address():
    assert list(inspect.signature(twg.plan_thin).parameters) == ["n", "h", "f", "sms"]
    assert twg.plan_thin(2048, 1024, 4, SMS) == twg.plan_thin(2048, 1024, 4, SMS)
    assert twg.plan_thin(2048, 1024, 4, SMS) == twg.ThinPlan(64, 4, 32, 8, 16, 64)
    assert twg.plan_of("thin", 2048, 1024, 4, SMS) == twg.plan_thin(2048, 1024, 4, SMS)
    assert twg.plan_of("fma", 1024, 2048, 60, SMS) == twg.plan_fp32(1024, 2048, 60, SMS)
    assert twg.plan_of("wgmma", 1024, 2048, 2048, SMS) is None
    with pytest.raises(ValueError):
        twg.plan_thin(2048, 1024, 17, SMS)


def test_plan_thin_constants_match_the_kernel_source():
    src = (build.CSRC / "wgrad_accum.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("kThinTileH") == twg.THIN_TILE_H
    assert const("kThinCols") == twg.THIN_COLS
    assert const("kThinThreads") == twg.THIN_THREADS
    assert const("kThinMaxF") == twg.THIN_MAX_F
    assert const("kThinThreads") // (const("kThinTileH") // const("kThinCols")) == twg.THIN_BK
    for fp in twg.THIN_FS:  # every padded width has its kernel
        assert f"fp == {fp} ? wgrad_thin_kernel<{fp}>" in src
    assert twg._PATH_CODE["thin"] == 3 and "if (path == 3)  // thin" in src


def test_kernel_launcher_never_takes_cpu_tensors():
    before, by_path = twg.launches, dict(twg.launches_by_path)
    with pytest.raises(ValueError, match="CUDA"):
        twg.wgrad_accum_cuda(torch.zeros(4, 3), torch.zeros(4, 2), torch.zeros(3, 2))
    assert twg.launches == before and twg.launches_by_path == by_path


# --------------------------------------------------------------------- #
# RMSNorm backward
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("shape", [(2, 16, 48), (32, 64), (3, 2048)])
def test_rmsnorm_backward_matches_jax(shape):
    rng = np.random.default_rng(2)
    x = rng.standard_normal(shape).astype(np.float32)
    g = (rng.standard_normal(shape[-1:]) * 0.5).astype(np.float32)
    dy = rng.standard_normal(shape).astype(np.float32)

    xt = torch.from_numpy(x).requires_grad_(True)
    gt = torch.from_numpy(g).requires_grad_(True)
    y = ops.rmsnorm(xt, gt)
    dx, dg = torch.autograd.grad(y, [xt, gt], torch.from_numpy(dy))

    want_dx, want_dg = jax_rms_bwd(False, True, (jnp.asarray(x), jnp.asarray(g)), jnp.asarray(dy))
    _, vjp = jax.vjp(lambda x_, g_: jmod.rmsnorm(g_, x_), jnp.asarray(x), jnp.asarray(g))
    ad_dx, ad_dg = vjp(jnp.asarray(dy))
    for got, wants in ((dx, (want_dx, ad_dx)), (dg, (want_dg, ad_dg))):
        for want in wants:
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    # the plain backward is the same function the autograd.Function calls
    pdx, pdg = rmsnorm_bwd_ref(xt.detach(), gt.detach(), torch.from_numpy(dy))
    torch.testing.assert_close(pdx, dx, rtol=0, atol=0)
    torch.testing.assert_close(pdg, dg, rtol=0, atol=0)


def test_rmsnorm_backward_keeps_dtypes():
    x = torch.randn(4, 8, dtype=torch.bfloat16, requires_grad=True)
    g = torch.zeros(8, dtype=torch.bfloat16, requires_grad=True)
    dx, dg = torch.autograd.grad(ops.rmsnorm(x, g), [x, g], torch.ones(4, 8, dtype=torch.bfloat16))
    assert dx.dtype == torch.bfloat16 and dg.dtype == torch.bfloat16


# --------------------------------------------------------------------- #
# the CUDA kernel (card only)
# --------------------------------------------------------------------- #
@pytest.mark.cuda
@pytest.mark.parametrize("n,h,f,dtype,path", [
    (1024, 2048, 2048, torch.bfloat16, "wgmma"),
    (1024, 2048, 1024, torch.bfloat16, "wgmma"),
    (1024, 2048, 8192, torch.bfloat16, "wgmma"),
    (1024, 8192, 2048, torch.bfloat16, "wgmma"),
    (1000, 2048, 2048, torch.bfloat16, "wgmma"),  # N not a multiple of 64
    (40, 200, 296, torch.bfloat16, "wgmma"),  # every edge ragged, TMA zero fill
    (32, 48, 96, torch.float32, "fma"),
    (77, 129, 257, torch.bfloat16, "mma_sync"),
    (1024, 2048, 60, torch.float32, "fma"),  # qwen2-moe's router: split 8
    (1024, 7168, 16, torch.float32, "fma"),  # deepseek-v3's cut's router: split 8
    (77, 129, 257, torch.float32, "fma"),  # ragged: 4-byte copies
    (2048, 1024, 4, torch.bfloat16, "thin"),  # xlstm's mfg, mig: split 8
    (1024, 1024, 4, torch.bfloat16, "thin"),
    (77, 136, 5, torch.bfloat16, "thin"),  # ragged N, F padded to 8
])
def test_cuda_kernel_matches_plain(n, h, f, dtype, path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs this check on the H100")
    gen = torch.Generator(device="cuda").manual_seed(0)
    a = (torch.randn(n, h, generator=gen, device="cuda") * 0.5).to(dtype)
    g = (torch.randn(n, f, generator=gen, device="cuda") * 0.5).to(dtype)
    acc = torch.randn(h, f, generator=gen, device="cuda")
    want = wgrad_accum_ref(a, g, acc)
    assert twg.plan_launch(n, h, f, dtype, a.data_ptr(), g.data_ptr(), acc.data_ptr()) == path
    before, on_path = twg.launches, twg.launches_by_path[path]
    clone = acc.clone()
    got = ops.wgrad_accum(a, g, clone)  # in place, on a clone
    torch.cuda.synchronize()
    assert got is clone and twg.launches == before + 1
    assert twg.launches_by_path[path] == on_path + 1
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)
    ptr = acc.data_ptr()
    ops.wgrad_accum(a, g, acc)  # in place, on the original
    torch.cuda.synchronize()
    assert acc.data_ptr() == ptr
    torch.testing.assert_close(acc, want, rtol=tol, atol=tol)
    # two launches on the same inputs agree bit for bit: no atomics, a fixed order
    assert torch.equal(acc.view(torch.int32), got.view(torch.int32))
