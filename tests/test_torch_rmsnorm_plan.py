"""The RMSNorm kernel's launch plan (``repro_torch.kernels.rmsnorm.plan_launch``).

The plan is plain Python, so its choices are checked here on the CPU: the
path each shape and alignment takes, the ring's fit in a block's shared
memory, the persistent grid's size, and that the plan's constants agree
with those compiled into ``csrc/rmsnorm.cu``.  The kernel itself runs only
on the card (``tests/test_torch_kernels.py::test_cuda_kernel_matches_plain``
and ``chip_smoke.py`` phase 3).
"""

import re

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import rmsnorm as trms  # noqa: E402

SMS = 132  # an H100 SXM's SMs
WIDTHS = (48, 64, 2048, 2304, 4096, 5120, 6144, 8192)  # every width of the port's dense configs
DTYPES = (torch.bfloat16, torch.float32)
ALIGNED = 1 << 20  # a 16-byte aligned address


def _size(dtype):
    return torch.tensor([], dtype=dtype).element_size()


def _plan(n, h, dtype, g_dtype=None, x_ptr=ALIGNED, y_ptr=ALIGNED, sms=SMS):
    return trms.plan_launch(n, h, dtype, g_dtype or dtype, x_ptr, y_ptr, sms)


@pytest.mark.parametrize("n", [1000, 1024, 4100])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("h", WIDTHS)
def test_bulk_for_aligned_rows_at_every_dense_width(h, dtype, n):
    plan = _plan(n, h, dtype)
    assert plan.path == "bulk"
    row_bytes = h * _size(dtype)
    assert plan.rows >= 1 and plan.stages >= 2 and plan.warps_per_row in (1, 2, 4, 8)
    # each stage serves one consumer group in every round
    assert plan.stages % (8 // plan.warps_per_row) == 0
    # a warp's share of a row stays within the one-warp limit unless 8 warps own it; more
    # warps a row only where half as many would leave a block's tiles for a second round
    wpr = plan.warps_per_row
    assert wpr == 8 or row_bytes <= wpr * 4608
    tiles = -(-n // plan.rows)
    per_block = -(-tiles // plan.grid)
    assert wpr == 1 or row_bytes > wpr // 2 * 4608 or 8 // wpr >= per_block  # why not fewer
    assert wpr == 8 or 8 // (2 * wpr) < per_block  # why not more
    assert plan.grid == min(tiles, trms.MAX_BLOCKS_PER_SM * SMS)


@pytest.mark.parametrize("g_dtype", DTYPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_the_path_does_not_depend_on_g(dtype, g_dtype):
    for n, h in ((4100, 2304), (2, 2048), (1000, 2047)):
        assert _plan(n, h, dtype, g_dtype) == _plan(n, h, dtype, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("h", [2048, 2304, 8192])
def test_rowwise_for_a_misaligned_view(h, dtype):
    n = 1000
    buf = torch.zeros(1 + n * h, dtype=dtype)
    x = buf[1:].view(n, h)  # contiguous, one element off the allocation's alignment
    assert x.is_contiguous() and x.data_ptr() % 16
    plan = trms.plan_launch(n, h, dtype, dtype, x.data_ptr(), ALIGNED, SMS)
    assert plan.path == "rowwise" and plan.grid == n
    assert _plan(n, h, dtype, y_ptr=ALIGNED + _size(dtype)).path == "rowwise"  # y misaligned
    assert _plan(2, h, dtype, x_ptr=x.data_ptr()).path == "rowwise"  # decode rows too


@pytest.mark.parametrize("n", [1, 2, 1000, 4100])
@pytest.mark.parametrize("dtype,h", [(torch.bfloat16, 2047), (torch.bfloat16, 2052),
                                     (torch.bfloat16, 100), (torch.float32, 2047),
                                     (torch.float32, 2050), (torch.float32, 5)])
def test_rowwise_for_rows_not_a_multiple_of_16_bytes(dtype, h, n):
    assert (h * _size(dtype)) % 16
    plan = _plan(n, h, dtype)
    assert plan.path == "rowwise" and plan.grid == n


@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("h", WIDTHS)
def test_latency_at_decode_rows(h, dtype, n):
    plan = _plan(n, h, dtype)
    assert plan.path == "latency" and plan.grid == n


def test_latency_up_to_one_row_an_sm_and_8192_wide():
    assert _plan(SMS, 2304, torch.bfloat16).path == "latency"
    assert _plan(SMS + 1, 2304, torch.bfloat16).path == "bulk"
    assert _plan(2, 8192, torch.float32).path == "latency"
    assert _plan(2, 8200, torch.float32).path == "bulk"  # too wide for the registers
    assert _plan(8, 2048, torch.bfloat16, sms=4).path == "bulk"  # the card's SMs decide


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("h", WIDTHS + (16384,))
def test_ring_fits_a_block(h, dtype):
    plan = _plan(4100, h, dtype)
    row_bytes = h * _size(dtype)
    assert plan.path == "bulk"
    assert plan.stages * plan.rows * row_bytes + 4 * h <= plan.smem_bytes <= trms.SMEM_PER_BLOCK
    # two blocks an SM wherever two stages of the row and g fit in half an SM's 228 KB
    if 2 * row_bytes + 4 * h + 200 <= 233472 // 2 - 1024:
        assert 2 * (plan.smem_bytes + 1024) <= 233472


def test_ring_fits_at_8192_in_float32():
    plan = _plan(4100, 8192, torch.float32)
    assert plan.path == "bulk" and plan.warps_per_row == 8 and plan.stages >= 2
    assert plan.stages * plan.rows * 8192 * 4 + 8192 * 4 <= 227 * 1024


def test_main_path_shapes_keep_two_blocks_an_sm_and_a_deep_ring():
    # gemma2's prefill: ~16 rows a block, one warp each; the training rows: ~4 rows a block,
    # two warps each, so all of a block's rows run at once
    for n, h, wpr in ((4100, 2304, 1), (1024, 2304, 2), (1024, 2048, 2)):
        plan = _plan(n, h, torch.bfloat16)
        assert plan.path == "bulk" and plan.warps_per_row == wpr and plan.rows == 1
        assert plan.stages == 16 and 2 * (plan.smem_bytes + 1024) <= 233472
        assert plan.grid == 2 * SMS


@pytest.mark.parametrize("per_sm", [1, 2])
@pytest.mark.parametrize("max_stages", [2, 4, 8, 12, 16])
@pytest.mark.parametrize("h,x_size", [(2304, 2), (5120, 2), (8192, 2), (2304, 4), (8192, 4)])
def test_bulk_stages_are_a_multiple_of_the_groups(h, x_size, max_stages, per_sm):
    plan = trms.bulk_plan(4100, h, x_size, SMS, per_sm, max_stages)
    if plan is None:  # fewer stages allowed than there are groups
        wpr = trms.bulk_plan(4100, h, x_size, SMS, per_sm, 16).warps_per_row
        assert max_stages < 8 // wpr
        return
    groups = 8 // plan.warps_per_row
    assert plan.stages % groups == 0 and max(2, groups) <= plan.stages <= max_stages
    assert plan.warps_per_row == trms.bulk_plan(4100, h, x_size, SMS, per_sm, 16).warps_per_row
    assert plan.smem_bytes <= min(trms.SMEM_PER_BLOCK, 233472 // per_sm - 1024)
    assert plan.grid == min(-(-4100 // plan.rows), per_sm * SMS)


def test_a_row_too_wide_for_the_ring_goes_rowwise():
    assert _plan(4100, 1 << 16, torch.float32).path == "rowwise"  # 256 KB a row


@pytest.mark.parametrize("sms", [1, 4, 78, 114, 132])
@pytest.mark.parametrize("n", [133, 1000, 1024, 4100, 65536, 1 << 20])
@pytest.mark.parametrize("h", [48, 2304, 8192])
def test_grid_never_exceeds_k_blocks_an_sm(h, n, sms):
    for dtype in DTYPES:
        plan = _plan(max(n, sms + 1), h, dtype, sms=sms)
        assert plan.path == "bulk"
        assert 1 <= plan.grid <= trms.MAX_BLOCKS_PER_SM * sms
        assert plan.grid <= -(-max(n, sms + 1) // plan.rows)


def test_plan_refuses_other_dtypes():
    with pytest.raises(TypeError):
        _plan(4, 8, torch.float16)
    with pytest.raises(TypeError):
        _plan(4, 8, torch.float32, g_dtype=torch.float64)


def test_plan_constants_match_the_kernel_source():
    src = (build.CSRC / "rmsnorm.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("kConsumerWarps") == trms._CONSUMER_WARPS
    assert const("kMaxSmem") == trms.SMEM_PER_BLOCK
    assert const("kLatMaxH") == trms._LATENCY_MAX_H
    assert "__launch_bounds__(kBulkThreads, 2)" in src and trms.MAX_BLOCKS_PER_SM == 2
    # the shared-memory layout: stages, g in fp32, 2 mbarriers a stage, 2 x 8 partials
    assert "stages * stage_stride(h, xsize, rows) + round_up(4u * h, 16) + 16u * stages +" in src
    assert trms._bulk_smem(2304, 4608, 1, 16) == 16 * 4608 + 9216 + 16 * 16 + 64


def test_launch_counters_start_per_path():
    assert set(trms.launches_by_path) == set(trms.PATHS) == {"bulk", "latency", "rowwise"}
