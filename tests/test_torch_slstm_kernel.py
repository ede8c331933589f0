"""The sLSTM time loop's kernel (``kernels/csrc/slstm_scan.cu``) and its
wrapper, without JAX.

On the CPU: the dispatch takes the plain version for CPU tensors and the
wrapper refuses what the kernel does not take (rank, dtype, contiguity,
mixed devices, an empty input), the kernel's launches need CUDA tensors,
the source is one of the build's, its note names what it replaces, and the
wrapper's layout constants (channels a block, steps a chunk, ring depths,
warps) are the source's and fit a block's shared memory.
On a CUDA card (marked ``cuda``; skipped here): forward and backward at
xlstm-350m's (1, 2048, 1024), its serving's ragged prefill (2, 513, 1024)
(513 steps: not a whole number of chunks), a ragged (3, 37, 40), (3, 37,
37) (h no multiple of 4: the 4-byte copies and a part-filled last block)
and (2, 70, 36) (16-byte copies, a part-filled last block) against
the plain version, h and the final state bit for bit (the kernel does the plain
loop's fp32 operations in its order, without contraction), the gradients
within 1e-5 of the largest (autograd sums a state's gradient terms in
another order), and two launches bit for bit.
"""

import re

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels import slstm_scan as sl  # noqa: E402
from repro_torch.kernels.ref import slstm_scan_ref  # noqa: E402

GRAD_RTOL = 1e-5


def _ins(b, s, h, device="cpu", seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    return tuple((torch.randn((b, s, h), generator=gen, device=device) * sc).contiguous()
                 for sc in (1.5, 1.5, 0.8))


def test_cpu_dispatch_is_the_plain_version():
    ins = _ins(2, 9, 5)
    hs, (c, n, m) = ops.slstm_scan(*ins)
    want, (wc, wn, wm) = slstm_scan_ref(*ins)
    assert torch.equal(hs, want) and torch.equal(c, wc) and torch.equal(n, wn)
    assert torch.equal(m, wm) and tuple(c.shape) == (2, 5)


@pytest.mark.parametrize("bad,err", [
    (lambda i, f, z: (i[0], f[0], z[0]), ValueError),
    (lambda i, f, z: (i.double(), f, z), TypeError),
    (lambda i, f, z: (i, f.transpose(1, 2).contiguous().transpose(1, 2), z), ValueError),
    (lambda i, f, z: (i, f, z[:, :3]), ValueError),
    (lambda i, f, z: (i[:, :0], f[:, :0], z[:, :0]), ValueError),
], ids=["rank", "dtype", "strides", "shape", "empty"])
def test_wrapper_refuses_what_the_kernel_does_not_take(bad, err):
    with pytest.raises(err):
        ops.slstm_scan(*bad(*_ins(2, 4, 6)))


def test_kernel_launch_needs_cuda_tensors():
    before = sl.launches
    with pytest.raises(ValueError, match="CUDA"):
        sl.forward(*_ins(1, 3, 4))
    assert sl.launches == before
    assert "slstm_scan" in build.sources()
    note = (build.CSRC / "slstm_scan.cu").read_text()
    assert "Replaces no TPU kernel" in note and "sm_90a" in note
    assert "src/repro/models/modules.py::apply_slstm" in note and "lax.scan" in note


def test_layout_constants_match_the_kernel_source():
    src = (build.CSRC / "slstm_scan.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("kChannels") == sl.CHANNELS and const("kChunk") == sl.CHUNK
    assert const("kFwdRing") == sl.FWD_RING and const("kBwdRing") == sl.BWD_RING
    assert const("kWarps") == sl.WARPS
    # each ring holds a chunk's pipeline (4 ticks forward, 5 backward) and at
    # least one chunk loading ahead of it
    assert sl.FWD_RING - const("kFwdDepth") >= 1 and sl.BWD_RING - const("kBwdDepth") >= 1
    # one sector a step of each array, and a block's shared memory within the
    # 227 KB it may opt into
    assert sl.CHANNELS * 4 % 32 == 0
    fwd = sl.FWD_RING * 4 * sl.CHUNK * sl.CHANNELS * 4
    bwd = sl.BWD_RING * (7 * sl.CHUNK + 3 * (sl.CHUNK + 1)) * sl.CHANNELS * 4
    assert max(fwd, bwd) <= 232448
    assert sl.WARPS * 32 <= 1024 and (sl.WARPS - 2) // 2 >= 1
    # the grid: one block each CHANNELS channels of a batch row
    assert sl.grid(1, 1024) == 128 and sl.grid(2, 1024) == 256 and sl.grid(3, 40) == 15


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 2048, 1024), (2, 513, 1024), (3, 37, 40), (3, 37, 37),
                                   (2, 70, 36)],
                         ids=["xlstm", "prefill-513", "ragged", "ragged-h37", "ragged-h36"])
def test_kernel_matches_plain_version_on_the_card(shape):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs this check on the H100")
    ins = _ins(*shape, device="cuda")
    dh = torch.randn(shape, device="cuda", generator=torch.Generator("cuda").manual_seed(1))
    runs = []
    for fn in (ops.slstm_scan, ops.slstm_scan, slstm_scan_ref):
        xs = [t.clone().requires_grad_(True) for t in ins]
        hs, state = fn(*xs)
        hs.backward(dh)
        runs.append((hs.detach(), [t.detach() for t in state], [x.grad for x in xs]))
    torch.cuda.synchronize()
    (h1, s1, g1), (h2, s2, g2), (hr, sr, gr) = runs
    assert torch.equal(h1, h2) and all(torch.equal(a, b) for a, b in zip(s1 + g1, s2 + g2))
    assert torch.equal(h1, hr) and all(torch.equal(a, b) for a, b in zip(s1, sr))
    for a, b in zip(g1, gr):
        assert float((a - b).abs().max()) <= GRAD_RTOL * float(b.abs().max())
