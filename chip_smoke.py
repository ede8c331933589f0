#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases, in order; any failed check raises and the exit code is not 0:

1. build   -- compile every CUDA source of ``src/repro_torch/kernels/csrc/``
              with nvcc (sm_90a) into ``build/repro_torch/``.
2. card    -- the card's name and power limit from nvidia-smi.
3. kernels -- each kernel against its plain PyTorch version on the card at
              the serving path's shapes, with device times (CUDA events
              around a CUDA graph of many calls) of the kernel, the plain
              version and one PyTorch library call, and the bound.
4. reduced -- reduced internlm2 (float32) served on cuda and on cpu: logits
              within 1e-4 and identical greedy tokens.
5. serve   -- internlm2-1.8b at full width and depth (bf16, random weights
              from a seed): 4 pipeline stages on the one card, 8 request
              groups of 2, 512-token prompts, 16 greedy tokens.  Kernel
              launch counts are read around this run only.
6. consistency -- decoding token s after a prefill of s tokens matches the
              last position of a prefill of s + 1 tokens, at full width.
7. profile -- the device's busy share in prefill and in decode, and the
              kernels that take the device time, from torch.profiler.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.  Without a CUDA card the
script exits 1 and prints no result.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import get_config, get_reduced  # noqa: E402
from repro_torch.core.schedules.ir import Placement  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import rmsnorm as rms_kernel  # noqa: E402
from repro_torch.kernels.ref import rmsnorm_ref  # noqa: E402
from repro_torch.launch.serve import serve  # noqa: E402
from repro_torch.models.lm import RunSpec, group_layout, init_params  # noqa: E402
from repro_torch.tree import tree_map  # noqa: E402

# NVIDIA H100 SXM data sheet: HBM3 rate and fp32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

ARCH = "internlm2_1_8b"
P, M, B, PROMPT, NEW = 4, 8, 2, 512, 16  # full-width serving run
RED_P, RED_M, RED_B, RED_PROMPT, RED_NEW = 2, 4, 2, 16, 4  # reduced cuda-vs-cpu run
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}  # as tests/test_kernels.py
# full-width consistency in bf16: both paths round every product to bf16 (8
# mantissa bits) but in other shapes, so ~1-ulp differences (2^-9 relative)
# enter each of the 48 sublayers and add up like a random walk: about
# sqrt(48) * 2^-9 = 1.4% of the logits' norm.  Twice that is the limit; the
# max bound catches a gross error in a few logits.
CONSIST_REL_L2 = 3e-2
CONSIST_MAX_ABS = 0.25
# norm launches of each ported kind per call: one rmsnorm in attn and mlp,
# in prefill (the port reuses the forward's k/v) and in decode alike
NORMS_PER_KIND = {"attn": 1, "mlp": 1}


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def eager_ms(fn, iters: int = 200, warmup: int = 20) -> float:
    """Mean time of one call issued eagerly from Python, from CUDA events
    around ``iters`` calls: the device time plus any gap the host leaves."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 100, replays: int = 5) -> float:
    """Mean device time of one call: ``iters`` calls captured in one CUDA
    graph, replayed between CUDA events, so host dispatch is not counted.
    The inputs stay in L2 between calls, as they do on the serving path,
    where the norm reads what the previous op just wrote."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up off the capture, as torch asks
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * replays)


def phase_build() -> None:
    t0 = time.perf_counter()
    libs = build.build()
    print(f"[build] {len(libs)} kernel source(s) in {time.perf_counter() - t0:.1f}s: "
          + ", ".join(f"{n} -> {p.relative_to(ROOT)}" for n, p in libs.items()))
    for n, p in libs.items():
        for line in p.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {n}: {line.strip()}")


def phase_card() -> None:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    print(out[0].strip())  # one card: the one this script runs on
    print(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")


def rmsnorm_bound_ms(n: int, h: int, x_dtype, g_dtype):
    """Least time for the work: bytes (x read, y written, g read, once each)
    over the HBM rate, or ~4 fp32 operations per element over the fp32 rate."""
    xs = torch.tensor([], dtype=x_dtype).element_size()
    gs = torch.tensor([], dtype=g_dtype).element_size()
    byte_ms = (2 * n * h * xs + h * gs) / HBM_BYTES_PER_S * 1e3
    op_ms = 4 * n * h / FP32_OPS_PER_S * 1e3
    return (byte_ms, "bytes") if byte_ms >= op_ms else (op_ms, "operations")


def phase_kernels(cfg_full, cfg_red):
    """RMSNorm on the card at the shapes the serving path gives it."""
    bf16, f32 = torch.bfloat16, torch.float32
    d = cfg_full.d_model
    shapes = [  # (label, N rows, H, x dtype, g dtype)
        ("prefill", B * PROMPT, d, bf16, bf16),
        ("decode", B, d, bf16, bf16),
        ("reduced", B * RED_PROMPT, cfg_red.d_model, f32, f32),
        ("ragged", 1000, d, bf16, bf16),
    ]
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = {}
    for label, n, h, xd, gd in shapes:
        x = torch.randn(n, h, generator=gen, device="cuda").to(xd)
        g = (torch.randn(h, generator=gen, device="cuda") * 0.5).to(gd)
        y = rms_kernel.rmsnorm_fused(x, g)
        torch.cuda.synchronize()
        ref = rmsnorm_ref(x, g)
        err = float((y.float() - ref.float()).abs().max())
        tol = TOL[xd]
        torch.testing.assert_close(y.float(), ref.float(), rtol=tol, atol=tol)
        w = (1.0 + g.float()).to(xd)
        lib = getattr(torch.nn.functional, "rms_norm", None)
        kernel = lambda: rms_kernel.rmsnorm_fused(x, g)  # noqa: E731
        plain = lambda: rmsnorm_ref(x, g)  # noqa: E731
        library = None if lib is None else (lambda: lib(x, (h,), w, 1e-6))
        row = dict(
            max_abs_err=err,
            ms=device_ms(kernel),
            plain_ms=device_ms(plain),
            library_ms=None if library is None else device_ms(library),
        )
        row["bound_ms"], row["bound_by"] = rmsnorm_bound_ms(n, h, xd, gd)
        rows[label] = row
        print(f"[kernels] rmsnorm {label} N={n} H={h} x={xd} g={gd}: max_abs_err={err:.3g} "
              f"(tol {tol}) device ms: kernel={row['ms']:.5f} plain={row['plain_ms']:.5f} "
              f"library={row['library_ms']} bound={row['bound_ms']:.5f} ({row['bound_by']}); "
              f"eager ms per call: kernel={eager_ms(kernel):.5f} plain={eager_ms(plain):.5f} "
              f"library={None if library is None else eager_ms(library)}")
    return rows


def phase_reduced(cfg):
    spec = RunSpec(p=RED_P, n_chunks=1, microbatch=RED_B, seq_len=RED_PROMPT, m=RED_M)
    stacked, shared = init_params(cfg, spec, Placement.linear(RED_P), seed=1, device="cpu")
    prompts = np.random.default_rng(1).integers(0, cfg.vocab, (RED_M, RED_B, RED_PROMPT))
    on_cpu = serve(cfg, stacked, shared, prompts, p=RED_P, new_tokens=RED_NEW)
    to_cuda = lambda a: a.to("cuda")  # noqa: E731
    on_gpu = serve(cfg, tree_map(to_cuda, stacked), tree_map(to_cuda, shared), prompts,
                   p=RED_P, new_tokens=RED_NEW)
    errs = []
    for a, b in zip(on_gpu.logits, on_cpu.logits):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-4)
        errs.append(float((a.cpu() - b).abs().max()))
    check(torch.equal(on_gpu.tokens.cpu(), on_cpu.tokens), "reduced greedy tokens differ")
    print(f"[reduced] p={RED_P} m={RED_M} b={RED_B} prompt={RED_PROMPT} new={RED_NEW} f32: "
          f"cuda vs cpu logits max_abs_err per step {[f'{e:.3g}' for e in errs]} (tol 1e-4), "
          f"tokens identical ({on_gpu.tokens.numel()})")


def expected_norm_launches(cfg, p, m, steps):
    blocks, g = group_layout(cfg, p, 1)
    per_group = p * sum(NORMS_PER_KIND[k] for kinds in blocks for k in kinds) + 1  # + sink
    return steps * m * per_group


def phase_serve(cfg):
    spec = RunSpec(p=P, n_chunks=1, microbatch=B, seq_len=PROMPT, m=M)
    t0 = time.perf_counter()
    stacked, shared = init_params(cfg, spec, Placement.linear(P), seed=0, device="cuda")
    torch.cuda.synchronize()
    print(f"[serve] init {cfg.name} ({cfg.n_layers} layers, d={cfg.d_model}, {cfg.dtype}) "
          f"on cuda in {time.perf_counter() - t0:.1f}s")
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, (M, B, PROMPT))
    serve(cfg, stacked, shared, prompts, p=P, new_tokens=1)  # warm-up (cuBLAS, allocator)

    torch.cuda.reset_peak_memory_stats()
    rms_kernel.launches = 0
    res = serve(cfg, stacked, shared, prompts, p=P, new_tokens=NEW,
                log=lambda s: print(f"[serve] {s}"))
    launches = rms_kernel.launches

    want = expected_norm_launches(cfg, P, M, 1 + NEW)
    check(launches == want and launches > 0,
          f"rmsnorm launches {launches} != {want} implied by the port's structure")
    for lg in res.logits:
        check(lg.shape == (M, B, cfg.vocab), f"logits shape {tuple(lg.shape)}")
        check(bool(torch.isfinite(lg.float()).all()), "non-finite logits")
    check(res.tokens.shape == (M, B, NEW + 1), f"tokens shape {tuple(res.tokens.shape)}")
    check(bool(((res.tokens >= 0) & (res.tokens < cfg.vocab)).all()), "token out of range")
    decode_ms = [s * 1e3 for s in res.decode_s]
    print(f"[serve] p={P} m={M} b={B} prompt={PROMPT} new={NEW}: "
          f"prefill_ms={res.prefill_s * 1e3:.1f} "
          f"decode_ms_per_step mean={np.mean(decode_ms):.2f} median={np.median(decode_ms):.2f} "
          f"min={min(decode_ms):.2f} max={max(decode_ms):.2f} "
          f"generated_tok_per_s={M * B * NEW / sum(res.decode_s):.1f} "
          f"max_memory_allocated_GiB={torch.cuda.max_memory_allocated() / 2**30:.2f}")
    print(f"[serve] rmsnorm launches {launches} == expected {want} "
          f"({1 + NEW} steps x {M} groups x ({P} stages x "
          f"{sum(NORMS_PER_KIND[k] for kinds in group_layout(cfg, P, 1)[0] for k in kinds)} "
          f"norms + 1 sink))")
    return stacked, shared, prompts, res, launches


def phase_consistency(cfg, stacked, shared, prompts, res):
    longer = np.concatenate([prompts, res.tokens[..., :1].cpu().numpy()], axis=-1)
    res2 = serve(cfg, stacked, shared, longer, p=P, new_tokens=0)
    dec, ref = res.logits[1].float(), res2.logits[0].float()
    rel = float((dec - ref).norm() / ref.norm())
    mx = float((dec - ref).abs().max())
    control = float((res.logits[0].float() - ref).norm() / ref.norm())  # one position off
    agree = float((dec.argmax(-1) == ref.argmax(-1)).float().mean())
    print(f"[consistency] decode@{PROMPT} vs prefill of {PROMPT + 1}: rel_l2={rel:.3g} "
          f"(limit {CONSIST_REL_L2}) max_abs={mx:.3g} (limit {CONSIST_MAX_ABS}) "
          f"top1_agree={agree:.3f}; control, prefill@{PROMPT - 1} vs it: rel_l2={control:.3g}")
    check(rel <= CONSIST_REL_L2 and mx <= CONSIST_MAX_ABS, "prefill->decode consistency")


def _device_intervals(prof):
    """(start_us, end_us, name) of every device activity in a profile."""
    return [(e.time_range.start, e.time_range.end, e.name) for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def _union_us(intervals) -> float:
    busy, end = 0.0, float("-inf")
    for s, e, _ in sorted(intervals):
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy


def phase_profile(cfg, stacked, shared, prompts, new_tokens: int = 4):
    """Device busy share of the serving path under torch.profiler: a
    prefill-only run and a prefill + decode run; decode's share is their
    difference.  The profiler adds host time to every op, so the idle share
    it shows is an upper bound on the unprofiled run's."""
    from torch.profiler import ProfilerActivity, profile

    runs = {}
    for new in (0, new_tokens):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            serve(cfg, stacked, shared, prompts, p=P, new_tokens=new)
            wall_us = (time.perf_counter() - t0) * 1e6
        iv = _device_intervals(prof)
        runs[new] = (wall_us, _union_us(iv), iv)
    (w0, b0, _), (w1, b1, iv1) = runs[0], runs[new_tokens]
    if not iv1:
        print("[profile] the profiler recorded no device activity: busy share not measured")
        return
    print(f"[profile] prefill: wall {w0 / 1e3:.1f} ms, device busy {b0 / 1e3:.1f} ms "
          f"(idle share {1 - b0 / w0:.3f})")
    print(f"[profile] decode ({new_tokens} steps): wall {(w1 - w0) / 1e3:.1f} ms, device busy "
          f"{(b1 - b0) / 1e3:.1f} ms (idle share {1 - (b1 - b0) / (w1 - w0):.3f})")
    by_name = {}
    for s_, e_, name in iv1:
        by_name[name] = by_name.get(name, 0.0) + (e_ - s_)
    total = sum(by_name.values())
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        print(f"[profile] {us / total:6.1%} {us / 1e3:9.2f} ms  {name[:100]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA card visible to torch; nothing was run", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg_full, cfg_red = get_config(ARCH), get_reduced(ARCH)
    t_start = time.perf_counter()
    phase_build()
    phase_card()
    rows = phase_kernels(cfg_full, cfg_red)
    phase_reduced(cfg_red)
    stacked, shared, prompts, res, launches = phase_serve(cfg_full)
    phase_consistency(cfg_full, stacked, shared, prompts, res)
    phase_profile(cfg_full, stacked, shared, prompts)
    print(f"[done] all phases passed in {time.perf_counter() - t_start:.1f}s")

    main_row = rows["prefill"]
    print(json.dumps({"kernels": [{
        "name": "rmsnorm",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rmsnorm.cu",
        "replaces": "src/repro/kernels/rmsnorm.py:29",
        "launches": launches,
        "max_abs_err": main_row["max_abs_err"],
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
