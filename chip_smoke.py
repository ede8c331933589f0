#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases, in order; any failed check raises and the exit code is not 0:

1. build   -- compile every CUDA source of ``src/repro_torch/kernels/csrc/``
              with nvcc (sm_90a) into ``build/repro_torch/``, all at once.
2. card    -- the card's name and power limit from nvidia-smi.
3. kernels -- each kernel against its plain PyTorch version on the card at
              the shapes its path gives it, with device times (CUDA events
              around a CUDA graph of many calls) of the kernel, the plain
              version and one PyTorch library call, and the bound: RMSNorm
              at the serving shapes, wgrad_accum at the four (H, F) shapes
              of the training step's W ops (N = 1024, bf16 a/g, fp32 acc),
              plus a ragged N, fp32 and ragged shapes.  wgrad_accum adds
              into a clone of acc in place and is held against the plain
              version on the original; its path (wgmma / mma_sync / fma) is
              printed per shape, kernel and library are timed in
              turns (kernel, library, library, kernel), and the wrapper's
              eager host time per call is measured.
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
8. train-reduced -- reduced internlm2 (float32), p=2, m=4: 3 training steps
              (AdamW + post-validation) on cuda and on cpu; losses within
              1e-5 relative, grad norms within 1e-4.
9. train   -- internlm2-1.8b at full width and depth (bf16, random weights
              from a seed): 4 stages on the one card, 8 microbatches of
              1 x 1024 tokens from the synthetic stream, 3 steps each under
              1f1b, zb-h1 and zb-h2: step time, tokens/s, peak memory,
              losses, grad norms; both kernels' launch counts, read around
              each schedule's run, equal the counts the structure implies,
              and every wgrad_accum launch took the wgmma path.
10. train-checks -- step-0 loss in the band of tests/test_arch_smoke.py and
              identical across schedules, later losses within a stated
              tolerance; the step-0 full-width gradient of the B/W-split
              pipeline against plain torch.autograd through the same model.
11. profile-train -- torch.profiler over one full-width zb-h1 step, run
              right after that schedule's steps in phase 9: host spans of
              the pipeline and the optimizer, device busy share, top
              kernels, wgrad_accum's share of device time.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.  Without a CUDA card the
script exits 1 and prints no result.
"""

from __future__ import annotations

import functools
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
from repro_torch.core.executor import PipelineExecutor  # noqa: E402
from repro_torch.core.schedules import compile_plan  # noqa: E402
from repro_torch.core.schedules.ir import Placement  # noqa: E402
from repro_torch.data import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import rmsnorm as rms_kernel  # noqa: E402
from repro_torch.kernels import wgrad_accum as wgrad_kernel  # noqa: E402
from repro_torch.kernels.ref import rmsnorm_ref, wgrad_accum_ref  # noqa: E402
from repro_torch.launch.serve import serve  # noqa: E402
from repro_torch.launch.steps import TrainStepConfig, build_train_step  # noqa: E402
from repro_torch.launch.train import make_schedule, side_from_batch, train  # noqa: E402
from repro_torch.models.lm import (  # noqa: E402
    RunSpec,
    build_program,
    group_layout,
    init_params,
    make_chunk_fn,
    make_sink_fn,
    make_src,
)
from repro_torch.models.modules import ShardCtx  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.tree import tree_flatten, tree_leaves, tree_map, tree_unflatten  # noqa: E402

# NVIDIA H100 SXM data sheet: HBM3 rate, fp32 rate outside the tensor cores,
# dense bf16 tensor-core rate
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12

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
# in prefill (the port reuses the forward's k/v), in decode and in a
# training forward alike (the norm's backward is plain torch, no kernel)
NORMS_PER_KIND = {"attn": 1, "mlp": 1}
# deferred linears (W ops, one wgrad_accum launch each) of each kind
LINEARS_PER_KIND = {"attn": 4, "mlp": 3}

# full-width training run: 4 stages on the card, m microbatches of b x seq
T_P, T_M, T_B, T_SEQ, T_STEPS = 4, 8, 1, 1024, 3
T_SCHEDULES = ("1f1b", "zb-h1", "zb-h2")
T_MEM_LIMIT_GB = 75.0  # above this peak, the schedule runs again at seq 512
# reduced cuda-vs-cpu training run
TR_P, TR_M, TR_B, TR_SEQ, TR_STEPS = 2, 4, 2, 32, 3
# the W products of the training step: (H, F) of wq/wo, wk/wv, wu/wg, wd
WGRAD_MAIN = (("wq,wo", 2048, 2048), ("wk,wv", 2048, 1024), ("wu,wg", 2048, 8192),
              ("wd", 8192, 2048))
# later full-width losses across schedules: the embedding gradient is a
# CUDA index_add_ (atomics, no fixed order), so it differs between runs by
# fp32 rounding (~1e-7 relative); AdamW's first steps are nearly
# scale-invariant and the bf16 cast of the updated weights flips a few
# hundred embedding entries by one ulp at most, which moves the loss by
# ~1e-6 relative.  1e-4 relative leaves a wide margin for that and none for
# a real difference between schedules.
T_LATER_LOSS_RTOL = 1e-4
DEV = "cuda"  # the device of the training phases
# step-0 gradient, pipeline vs plain autograd (bf16): the plain path rounds
# each microbatch's weight gradient to bf16 (2^-9 relative, ~1.1e-3 rms)
# where the pipeline keeps fp32; activation gradients agree to rounding
# (H100, 700 W: 1.63e-3 pooled, 1.66e-3 on the worst of the 58 leaves, the
# same in three runs).  Both limits are 1e-2, six times those readings.  The
# pooled norm is dominated by the embedding and head, so the worst leaf is
# gated too: a fault confined to one leaf kind (the wk and wv pairs swapped,
# one (H, F) case mis-tiled) puts an O(1) relative error on that leaf.  A
# leaf whose plain gradient is zero must be zero in the pipeline as well.
T_GRAD_REL_L2 = 1e-2
T_GRAD_WORST_LEAF = 1e-2


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


@functools.lru_cache(maxsize=None)
def _warmup_stream() -> torch.cuda.Stream:
    return torch.cuda.Stream()


def device_ms(fn, iters: int = 100, replays: int = 5) -> float:
    """Mean device time of one call: ``iters`` calls captured in one CUDA
    graph, replayed between CUDA events, so host dispatch is not counted.
    The inputs stay in L2 between calls, as they do on the serving path,
    where the norm reads what the previous op just wrote.  The warm-up runs
    on one side stream shared by all calls: cuBLAS keeps a workspace for
    every stream it has run on, so a new stream per call would leave one
    more workspace allocated for the rest of the run."""
    side = _warmup_stream()
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


def wgrad_bound_ms(n: int, h: int, f: int, in_dtype):
    """Least time for acc + a^T g: bytes (a and g read, acc read, out
    written, once each) over the HBM rate, or 2*N*H*F operations over the
    tensor-core bf16 rate (the fp32 rate for fp32 inputs)."""
    es = torch.tensor([], dtype=in_dtype).element_size()
    byte_ms = (n * (h + f) * es + 2 * h * f * 4) / HBM_BYTES_PER_S * 1e3
    rate = BF16_OPS_PER_S if in_dtype == torch.bfloat16 else FP32_OPS_PER_S
    op_ms = 2 * n * h * f / rate * 1e3
    return (byte_ms, "bytes") if byte_ms >= op_ms else (op_ms, "operations")


def _library_wgrad(a, g, acc):
    """One PyTorch call for acc + a^T g with an fp32 result, the yardstick."""
    return lambda: torch.addmm(acc, a.t(), g, out_dtype=torch.float32)


def host_us(fn, iters: int = 200) -> float:
    """Host time of one eager call: the enqueue alone, no device sync inside
    the window (the launch queue is deeper than ``iters``)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    us = (time.perf_counter() - t0) / iters * 1e6
    torch.cuda.synchronize()
    return us


def phase_kernels_wgrad(cfg_red):
    """wgrad_accum on the card at the W products of the training step, plus a
    ragged N, fp32 (the reduced model's path) and ragged shapes."""
    bf16, f32 = torch.bfloat16, torch.float32
    n = T_B * T_SEQ
    shapes = [(name, n, h, f, bf16) for name, h, f in WGRAD_MAIN] + [
        ("ragged-N", 1000, 2048, 2048, bf16),
        ("fp32", n, 2048, 2048, f32),
        ("reduced", TR_B * TR_SEQ, cfg_red.d_model, cfg_red.d_ff, f32),
        ("ragged-bf16", 1000, 200, 300, bf16),
        ("ragged-fp32", 77, 129, 257, f32),
    ]
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = {}
    for label, n_, h, f, dt in shapes:
        a = (torch.randn(n_, h, generator=gen, device="cuda") * 0.5).to(dt)
        g = (torch.randn(n_, f, generator=gen, device="cuda") * 0.5).to(dt)
        acc = torch.randn(h, f, generator=gen, device="cuda")
        path = wgrad_kernel.plan_launch(n_, h, f, dt, a.data_ptr(), g.data_ptr(), acc.data_ptr())
        ref = wgrad_accum_ref(a, g, acc)  # the plain version, on the original
        out = acc.clone()
        got = wgrad_kernel.wgrad_accum_cuda(a, g, out)  # the kernel, in place on a clone
        torch.cuda.synchronize()
        check(got is out, "wgrad_accum did not return the accumulator it updated")
        err = float((out - ref).abs().max())
        tol = TOL[dt]
        torch.testing.assert_close(out, ref, rtol=tol, atol=tol)
        # the plain version and the library call allocate an (H, F) output per
        # call, and the CUDA graph's pool keeps each one: fewer calls when large
        iters = 20 if h * f >= 2048 * 2048 else 100
        kernel = lambda: wgrad_kernel.wgrad_accum_cuda(a, g, out)  # noqa: E731
        library = _library_wgrad(a, g, acc)
        turns = [device_ms(fn, iters=iters) for fn in (kernel, library, library, kernel)]
        row = dict(
            max_abs_err=err,
            ms=(turns[0] + turns[3]) / 2,
            library_ms=(turns[1] + turns[2]) / 2,
            plain_ms=device_ms(lambda: wgrad_accum_ref(a, g, acc), iters=iters),
            path=path, host_us=host_us(kernel),
        )
        row["bound_ms"], row["bound_by"] = wgrad_bound_ms(n_, h, f, dt)
        rows[label] = row
        print(f"[kernels] wgrad_accum {label} N={n_} H={h} F={f} in={dt}: path={path} "
              f"max_abs_err={err:.3g} (tol {tol}) device ms: kernel={row['ms']:.5f} "
              f"library={row['library_ms']:.5f} [torch.addmm out_dtype=float32] "
              f"(in turns kernel/library/library/kernel: "
              f"{'/'.join(f'{t:.5f}' for t in turns)}) plain={row['plain_ms']:.5f} "
              f"bound={row['bound_ms']:.5f} ({row['bound_by']}, "
              f"{row['bound_ms'] / row['ms']:.1%} of it); "
              f"kernel TFLOP/s={2 * n_ * h * f / row['ms'] / 1e9:.1f}; "
              f"wrapper host us per eager call={row['host_us']:.1f}")
        del a, g, acc, out, got, ref, library
    torch.cuda.empty_cache()
    return rows


def _to(tree, device):
    return tree_map(lambda a: a.to(device), tree)


def phase_train_reduced(cfg):
    """The reduced model's training steps on cuda against cpu (float32)."""
    runs = {}
    for device in ("cpu", DEV):
        sched = make_schedule("zb-h1", TR_P, TR_M)
        spec = RunSpec(p=TR_P, n_chunks=1, microbatch=TR_B, seq_len=TR_SEQ, m=TR_M)
        step, _ = build_train_step(cfg, spec, compile_plan(sched), sched.placement,
                                   TrainStepConfig(adamw.AdamWConfig(lr=3e-3)))
        stacked, shared = init_params(cfg, spec, sched.placement, seed=2, device="cpu")
        data = SyntheticLM(DataConfig(global_batch=TR_M * TR_B, seq_len=TR_SEQ, vocab=cfg.vocab))
        runs[device] = train(cfg, spec, step, _to(stacked, device), _to(shared, device), data,
                             TR_STEPS)
    cpu, gpu = runs["cpu"], runs[DEV]
    l_rel = [abs(a - b) / abs(b) for a, b in zip(gpu.losses, cpu.losses)]
    g_rel = [abs(a - b) / abs(b) for a, b in zip(gpu.grad_norms, cpu.grad_norms)]
    print(f"[train-reduced] p={TR_P} m={TR_M} b={TR_B} seq={TR_SEQ} f32 zb-h1, {TR_STEPS} steps: "
          f"losses cuda={gpu.losses} cpu={cpu.losses} rel_err={[f'{e:.3g}' for e in l_rel]} "
          f"(tol 1e-5); grad_norm rel_err={[f'{e:.3g}' for e in g_rel]} (tol 1e-4)")
    check(max(l_rel) <= 1e-5, "reduced training losses differ between cuda and cpu")
    check(max(g_rel) <= 1e-4, "reduced training grad norms differ between cuda and cpu")


def expected_train_launches(cfg, p, m):
    """Per training step: (wgrad_accum, rmsnorm) launches the port's
    structure implies -- one wgrad per deferred linear per W op, one norm
    per attn/mlp forward plus the sink's, per microbatch."""
    blocks, _ = group_layout(cfg, p, 1)
    wgrad = m * p * sum(LINEARS_PER_KIND[k] for kinds in blocks for k in kinds)
    norms = m * (p * sum(NORMS_PER_KIND[k] for kinds in blocks for k in kinds) + 1)
    return wgrad, norms


def _train_full(cfg, name: str, seq: int):
    sched = make_schedule(name, T_P, T_M)
    spec = RunSpec(p=T_P, n_chunks=1, microbatch=T_B, seq_len=seq, m=T_M)
    step, _ = build_train_step(cfg, spec, compile_plan(sched), sched.placement, TrainStepConfig())
    stacked, shared = init_params(cfg, spec, sched.placement, seed=0, device=DEV)
    data = SyntheticLM(DataConfig(global_batch=T_M * T_B, seq_len=seq, vocab=cfg.vocab))
    torch.cuda.synchronize()
    print(f"[train] {name}: {torch.cuda.memory_allocated() / 1e9:.2f} GB allocated after init "
          f"(bf16 weights)")
    torch.cuda.reset_peak_memory_stats()
    wgrad_kernel.launches = 0
    wgrad_kernel.launches_by_path.update({k: 0 for k in wgrad_kernel.PATHS})
    rms_kernel.launches = 0
    res = train(cfg, spec, step, stacked, shared, data, T_STEPS,
                log=lambda s: print(f"[train] {name}: {s}"))
    launches = (wgrad_kernel.launches, rms_kernel.launches, dict(wgrad_kernel.launches_by_path))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    return res, launches, peak_gb, (stacked, shared, spec, sched, step, data)


def phase_train(cfg):
    """Full-width training under each schedule, from the same weights."""
    out = {}
    for name in T_SCHEDULES:
        seq = T_SEQ
        res, launches, peak_gb, state = _train_full(cfg, name, seq)
        if peak_gb > T_MEM_LIMIT_GB:
            print(f"[train] {name}: peak {peak_gb:.1f} GB > {T_MEM_LIMIT_GB} GB at seq {seq}; "
                  f"running it again at seq 512")
            del state
            torch.cuda.empty_cache()
            seq = 512
            res, launches, peak_gb, state = _train_full(cfg, name, seq)
        want = tuple(T_STEPS * n for n in expected_train_launches(cfg, T_P, T_M))
        check(launches[:2] == want, f"{name}: (wgrad_accum, rmsnorm) launches {launches[:2]} != "
              f"{want} implied by the port's structure")
        want_paths = {k: (want[0] if k == "wgmma" else 0) for k in wgrad_kernel.PATHS}
        check(launches[2] == want_paths, f"{name}: wgrad_accum launches by path {launches[2]} != "
              f"{want_paths}: every W op of the training step should take the wgmma path")
        for k, (loss, gn) in enumerate(zip(res.losses, res.grad_norms)):
            check(np.isfinite(loss) and np.isfinite(gn), f"{name} step {k}: non-finite loss/norm")
        med = float(np.median(res.step_s))
        tokens = T_M * T_B * seq
        print(f"[train] {name} p={T_P} m={T_M} b={T_B} seq={seq}: ms_per_step "
              f"median={med * 1e3:.1f} all={[round(t * 1e3, 1) for t in res.step_s]} "
              f"tokens_per_s={tokens / med:.0f} max_memory_allocated_GB={peak_gb:.2f} "
              f"losses={res.losses} grad_norms={res.grad_norms} amended={res.amended} "
              f"launches wgrad_accum={launches[0]} {launches[2]} rmsnorm={launches[1]} "
              f"(expected {want})")
        out[name] = dict(res=res, launches=launches, seq=seq, peak_gb=peak_gb)
        if name == "zb-h1":
            phase_profile_train(state)
        del state
        torch.cuda.empty_cache()
    return out


def _plain_grads(cfg, spec, stacked, shared, side):
    """Step-0 gradient by plain torch.autograd through the same model (plain
    x @ w products, the same RMSNorm function), per microbatch, summed in
    fp32; stacked like the pipeline's grads."""
    ctx = ShardCtx()
    chunk_fn, _, _ = make_chunk_fn(cfg, spec.p, 1, ctx)
    src_fwd, _ = make_src(cfg, ctx)
    sink_fn = make_sink_fn(cfg, ctx, spec.m)
    leaves, struct = tree_flatten((stacked, shared))
    alias = [t.detach().requires_grad_(t.is_floating_point()) for t in leaves]
    st, sh = tree_unflatten(struct, alias)
    acc = [torch.zeros(t.shape, dtype=torch.float32, device=t.device) for t in leaves]
    wrt = [k for k, t in enumerate(alias) if t.requires_grad]
    loss = 0.0
    for j in range(spec.m):
        side_j = tree_map(lambda a: a[j], side)
        with torch.enable_grad():
            x = src_fwd(sh, side_j)
            for s in range(spec.p):
                x = chunk_fn(tree_map(lambda a: a[s], st[0]), x, side_j)
            lj = sink_fn(sh, x, side_j)
            gs = torch.autograd.grad(lj, [alias[k] for k in wrt], allow_unused=True)
        loss += float(lj.detach())
        for k, g in zip(wrt, gs):
            if g is not None:
                acc[k] += g.float()
    return tree_unflatten(struct, acc), loss


def phase_train_checks(cfg, runs):
    band = (0.1 * np.log(cfg.vocab), 3.0 * np.log(cfg.vocab))
    first = {n: r["res"].losses[0] for n, r in runs.items()}
    for n, l0 in first.items():
        check(band[0] < l0 < band[1], f"{n}: step-0 loss {l0} outside {band}")
    same_seq = {r["seq"] for r in runs.values()} == {T_SEQ}
    if same_seq:
        check(len(set(first.values())) == 1, f"step-0 losses differ across schedules: {first}")
        ref = runs["1f1b"]["res"].losses
        worst = max(abs(a - b) / abs(b) for r in runs.values()
                    for a, b in zip(r["res"].losses[1:], ref[1:]))
        check(worst <= T_LATER_LOSS_RTOL, f"later losses differ across schedules by {worst}")
        print(f"[train-checks] step-0 loss {list(first.values())[0]} in band "
              f"({band[0]:.3f}, {band[1]:.3f}) and identical across {list(first)}; later "
              f"losses max rel diff across schedules {worst:.3g} (limit {T_LATER_LOSS_RTOL})")
    else:
        print(f"[train-checks] step-0 losses {first} in band; schedules ran at other seq lengths, "
              f"so no cross-schedule equality check")

    # step-0 gradient: the B/W-split pipeline against plain autograd
    sched = make_schedule("zb-h1", T_P, T_M)
    spec = RunSpec(p=T_P, n_chunks=1, microbatch=T_B, seq_len=T_SEQ, m=T_M)
    stacked, shared = init_params(cfg, spec, sched.placement, seed=0, device=DEV)
    data = SyntheticLM(DataConfig(global_batch=T_M * T_B, seq_len=T_SEQ, vocab=cfg.vocab))
    side = side_from_batch(data.batch_at(0), spec, DEV)
    grad_fn = PipelineExecutor(build_program(cfg, spec, sched.placement),
                               compile_plan(sched)).build_grad_fn()
    g_pipe, sg_pipe, loss_pipe = grad_fn(stacked, shared, side)
    pipe = tree_leaves((g_pipe, sg_pipe))
    del g_pipe, sg_pipe
    plain_tree, loss_plain = _plain_grads(cfg, spec, stacked, shared, side)
    plain = tree_leaves((plain_tree[0], plain_tree[1]))
    diff2 = sum(float((a - b).double().pow(2).sum()) for a, b in zip(pipe, plain))
    ref2 = sum(float(b.double().pow(2).sum()) for b in plain)
    rel = (diff2 / ref2) ** 0.5
    worst_leaf = max(float((a - b).double().norm()) / max(float(b.double().norm()), 1e-30)
                     for a, b in zip(pipe, plain))
    print(f"[train-checks] step-0 gradient, pipeline (zb-h1, wgrad_accum) vs plain autograd: "
          f"rel_l2 over {len(plain)} leaves = {rel:.3g} (limit {T_GRAD_REL_L2}); worst leaf "
          f"rel_l2 {worst_leaf:.3g} (limit {T_GRAD_WORST_LEAF}); loss {float(loss_pipe):.6f} vs "
          f"{loss_plain:.6f}")
    check(rel <= T_GRAD_REL_L2, "pipeline gradient disagrees with plain autograd")
    check(worst_leaf <= T_GRAD_WORST_LEAF, "a gradient leaf disagrees with plain autograd")
    check(abs(float(loss_pipe) - loss_plain) <= 1e-3 * abs(loss_plain), "step-0 loss differs")
    del pipe, plain, plain_tree, stacked, shared
    torch.cuda.empty_cache()


def phase_profile_train(state):
    """Device busy share of one full-width zb-h1 training step."""
    from torch.profiler import ProfilerActivity, profile

    stacked, shared, spec, sched, step, data = state
    opt, sopt = adamw.init(stacked), adamw.init(shared)
    side = side_from_batch(data.batch_at(T_STEPS), spec, DEV)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(stacked, shared, opt, sopt, side)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans = {}
    for e in prof.events():
        if e.name.startswith("train_step.") and e.device_type == torch.autograd.DeviceType.CPU:
            spans[e.name] = spans.get(e.name, 0.0) + (e.time_range.end - e.time_range.start)
    print("[profile-train] host spans: " + ", ".join(
        f"{k} {v / 1e3:.1f} ms" for k, v in sorted(spans.items())))
    # the spans show up on the device timeline too, as annotations: not kernels
    iv = [x for x in _device_intervals(prof) if not x[2].startswith("train_step.")]
    if not iv:
        print("[profile-train] the profiler recorded no device activity: busy share not measured")
        return
    busy = _union_us(iv)
    by_name = {}
    for s_, e_, name in iv:
        by_name[name] = by_name.get(name, 0.0) + (e_ - s_)
    total = sum(by_name.values())
    wg = sum(us for name, us in by_name.items() if "wgrad" in name)
    print(f"[profile-train] zb-h1 step: wall {wall_us / 1e3:.1f} ms, device busy {busy / 1e3:.1f} "
          f"ms (idle share {1 - busy / wall_us:.3f}); wgrad_accum kernels {wg / 1e3:.1f} ms = "
          f"{wg / total:.1%} of device time")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        print(f"[profile-train] {us / total:6.1%} {us / 1e3:9.2f} ms  {name[:100]}")


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


def _kernel_row(name, source, replaces, launches, by_path, row, **extra):
    return {
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": launches,
        "launches_by_path": by_path,
        **extra,
        "max_abs_err": row["max_abs_err"],
        "ms": row["ms"],
        "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"],
        "library_ms": row["library_ms"],
    }


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
    wrows = phase_kernels_wgrad(cfg_red)
    phase_reduced(cfg_red)
    stacked, shared, prompts, res, serve_launches = phase_serve(cfg_full)
    phase_consistency(cfg_full, stacked, shared, prompts, res)
    phase_profile(cfg_full, stacked, shared, prompts)
    del stacked, shared, res
    torch.cuda.empty_cache()
    print(f"[time] serving phases done at {time.perf_counter() - t_start:.1f}s")
    phase_train_reduced(cfg_red)
    runs = phase_train(cfg_full)
    phase_train_checks(cfg_full, runs)
    print(f"[done] all phases passed in {time.perf_counter() - t_start:.1f}s")

    wgrad_by_run = {f"train-{n}": r["launches"][0] for n, r in runs.items()}
    wgrad_by_path = {k: sum(r["launches"][2][k] for r in runs.values())
                     for k in wgrad_kernel.PATHS}
    rms_by_run = {"serve": serve_launches, **{f"train-{n}": r["launches"][1]
                                              for n, r in runs.items()}}
    print(json.dumps({"kernels": [
        _kernel_row("rmsnorm", "src/repro_torch/kernels/csrc/rmsnorm.cu",
                    "src/repro/kernels/rmsnorm.py:29", sum(rms_by_run.values()), rms_by_run,
                    rows["prefill"]),
        _kernel_row("wgrad_accum", "src/repro_torch/kernels/csrc/wgrad_accum.cu",
                    "src/repro/kernels/wgrad_accum.py:51", sum(wgrad_by_run.values()),
                    wgrad_by_run, wrows["wu,wg"], launches_by_kernel_path=wgrad_by_path),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
