"""The port's RMSNorm against the JAX package's oracle and Pallas kernel.

The plain PyTorch version (the CPU path of ``repro_torch.kernels.ops``) is
held against ``repro.kernels.ref.rmsnorm_ref`` and against the Pallas kernel
``rmsnorm_fused`` run in interpret mode, on the JAX package's ``RMS_SHAPES``
plus the decode row count of the reduced config (2, 48) and a ragged row
count at full width (3, 2048).  Tolerances are those of
``tests/test_kernels.py``: 1e-5 in float32 (other summation orders, a few
ulps), 2e-2 in bfloat16 (one bf16 rounding of the output, 8 mantissa bits).

The CUDA kernel itself runs only on the card: the case below (every dense
width, both dtypes, the decode rows and views one element off their
allocation, each on the path its plan names) skips here, and
``chip_smoke.py`` phase 3 runs a wider sweep on the H100.  The launch plan
is tested on the CPU in ``tests/test_torch_rmsnorm_plan.py``.
"""

import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.ref import rmsnorm_ref as jax_rmsnorm_ref  # noqa: E402
from repro.kernels.rmsnorm import rmsnorm_fused as jax_rmsnorm_fused  # noqa: E402

from repro_torch.interop import to_torch  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels import rmsnorm as trms  # noqa: E402
from repro_torch.kernels.ref import rmsnorm_ref  # noqa: E402

RMS_SHAPES = [(256, 128, 64), (512, 1024, 256), (128, 384, 128), (2, 48, 2), (3, 2048, 3)]
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _inputs(n, h, x_dtype, g_dtype, seed=1):
    rng = np.random.default_rng(seed)
    x = jnp.asarray(rng.standard_normal((n, h)) * 0.5, dtype=x_dtype)
    g = jnp.asarray(rng.standard_normal((h,)) * 0.5, dtype=g_dtype)
    return x, g


@pytest.mark.parametrize("g_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,h,br", RMS_SHAPES)
def test_plain_rmsnorm_matches_jax(n, h, br, x_dtype, g_dtype):
    x, g = _inputs(n, h, x_dtype, g_dtype)
    got = ops.rmsnorm(to_torch(np.asarray(x)), to_torch(np.asarray(g)))
    assert got.dtype == (torch.float32 if x_dtype == "float32" else torch.bfloat16)
    got = got.float().numpy()
    tol = TOL[x_dtype]
    for want in (jax_rmsnorm_ref(x, g), jax_rmsnorm_fused(x, g, br=br, interpret=True)):
        np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=tol, atol=tol)


def test_wrapper_flattens_leading_axes():
    x = torch.randn(2, 3, 48, generator=torch.Generator().manual_seed(0))
    g = torch.randn(48, generator=torch.Generator().manual_seed(1))
    got = ops.rmsnorm(x, g)
    assert got.shape == x.shape
    torch.testing.assert_close(got, rmsnorm_ref(x.reshape(6, 48), g).reshape(2, 3, 48))


@pytest.mark.parametrize(
    "x,g,err",
    [
        (torch.zeros(4, 8, 6)[:, -1:], torch.zeros(6), ValueError),  # y[:, -1:] slice
        (torch.zeros(4, 8).t(), torch.zeros(4), ValueError),  # transposed
        (torch.zeros(8), torch.zeros(8), ValueError),  # rank 1
        (torch.zeros(4, 8), torch.zeros(6), ValueError),  # g of another width
        (torch.zeros(4, 8, dtype=torch.float16), torch.zeros(8), TypeError),
        (torch.zeros(0, 8), torch.zeros(8), ValueError),
    ],
)
def test_wrapper_refuses_what_the_kernel_does_not_take(x, g, err):
    with pytest.raises(err):
        ops.rmsnorm(x, g)


def test_kernel_launcher_never_takes_cpu_tensors():
    before = trms.launches
    with pytest.raises(ValueError, match="CUDA"):
        trms.rmsnorm_fused(torch.zeros(2, 8), torch.zeros(8))
    assert trms.launches == before


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    if build.pathlib.Path("/usr/local/cuda/bin/nvcc").is_file():
        pytest.skip("a CUDA toolkit is installed at its default path")
    with pytest.raises(RuntimeError, match="nvcc"):
        build.build(["rmsnorm"])
    assert build.sources() == ["rmsnorm", "slstm_scan", "wgrad_accum"]


CUDA_CASES = ([(1024, 2048, torch.bfloat16, 0), (2, 2048, torch.bfloat16, 0),
               (32, 48, torch.float32, 0), (1000, 2048, torch.bfloat16, 0)]
              + [(n, h, dt, 0) for h in (48, 64, 2304, 4096, 5120, 6144, 8192)
                 for dt in (torch.bfloat16, torch.float32) for n in (2, 1000)]
              + [(1000, h, dt, 1) for h in (64, 2048, 2304) for dt in (torch.bfloat16,
                                                                     torch.float32)]
              + [(1000, 2047, torch.bfloat16, 0), (4100, 2304, torch.bfloat16, 0)])


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,x_dtype,offset", CUDA_CASES)
def test_cuda_kernel_matches_plain(n, h, x_dtype, offset):
    """The kernel against the plain version on the card, on the path its
    plan names; ``offset`` elements off the allocation makes a misaligned
    view (``chip_smoke.py`` phase 3 sweeps more shapes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs this check on the H100")
    gen = torch.Generator(device="cuda").manual_seed(0)
    buf = torch.randn(offset + n * h, generator=gen, device="cuda").to(x_dtype)
    x = buf[offset:].view(n, h)
    g = (torch.randn(h, generator=gen, device="cuda") * 0.5).to(x_dtype)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = trms.plan_launch(n, h, x_dtype, x_dtype, x.data_ptr(), 0, sms)
    assert plan.path == ("rowwise" if offset or h % 8 else "latency" if n <= sms else "bulk")
    before, on_path = trms.launches, trms.launches_by_path[plan.path]
    got = ops.rmsnorm(x, g)
    torch.cuda.synchronize()
    assert trms.launches == before + 1 and trms.launches_by_path[plan.path] == on_path + 1
    tol = 1e-5 if x_dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), rmsnorm_ref(x, g).float(), rtol=tol, atol=tol)
