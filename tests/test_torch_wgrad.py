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
* The wrapper refuses what the CUDA kernel would refuse, on the CPU too.
* The RMSNorm ``autograd.Function`` backward against the JAX ``_rms_bwd``
  and against ``jax.grad`` of ``modules.rmsnorm`` (f32, 1e-5: one rsqrt and
  a few sums in another order).
* The CUDA kernel itself runs only on the card: the ``cuda``-marked case
  skips here, and ``chip_smoke.py`` holds the kernel against the plain
  version on the H100 at the training path's shapes.
"""

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
RAGGED = [(32, 48, 96), (32, 96, 48), (77, 129, 257), (1, 3, 5)]
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


def test_wgrad_returns_a_new_tensor():
    a, g, acc = (torch.ones(4, 3), torch.ones(4, 2), torch.zeros(3, 2))
    out = ops.wgrad_accum(a, g, acc)
    assert out.data_ptr() != acc.data_ptr() and float(acc.abs().sum()) == 0.0
    torch.testing.assert_close(out, torch.full((3, 2), 4.0))


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


def test_kernel_launcher_never_takes_cpu_tensors():
    before = twg.launches
    with pytest.raises(ValueError, match="CUDA"):
        twg.wgrad_accum_cuda(torch.zeros(4, 3), torch.zeros(4, 2), torch.zeros(3, 2))
    assert twg.launches == before


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
@pytest.mark.parametrize("n,h,f,dtype", [(1024, 2048, 2048, torch.bfloat16),
                                         (1024, 2048, 8192, torch.bfloat16),
                                         (32, 48, 96, torch.float32),
                                         (77, 129, 257, torch.bfloat16)])
def test_cuda_kernel_matches_plain(n, h, f, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs this check on the H100")
    gen = torch.Generator(device="cuda").manual_seed(0)
    a = (torch.randn(n, h, generator=gen, device="cuda") * 0.5).to(dtype)
    g = (torch.randn(n, f, generator=gen, device="cuda") * 0.5).to(dtype)
    acc = torch.randn(h, f, generator=gen, device="cuda")
    before = twg.launches
    got = ops.wgrad_accum(a, g, acc)
    torch.cuda.synchronize()
    assert twg.launches == before + 1
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got, wgrad_accum_ref(a, g, acc), rtol=tol, atol=tol)
