#!/usr/bin/env python3
"""``wgrad_accum``'s thin-F kernel built in other layouts, on one CUDA card.

    PYTHONPATH=src python3 tools/wgrad_thin_variants.py

Copies ``csrc/wgrad_accum.cu`` with one or more of its thin-path constants
changed (``VARIANTS``: the tile's H columns, the columns a thread, the
steps whose loads a thread issues at once, the block's threads; a wider
tile or block would pass the 48 KB of static shared memory its per-warp
partials take at F = 16), builds
each copy with the repo's nvcc flags into ``build/wgrad_thin_variants/``,
all at once, and at the thin shapes of ``SHAPES`` (xlstm's mLSTM gate
products at N = 2048 and 1024, and two ragged ones) runs the source as
built under the split ``plan_thin`` picks and under every other split the
plan's steps allow, and each copy under the plan's split.  Each run: its
error against the plain version (within 2e-2, the bf16 tolerance), two
launches bit for bit, and its device time in turns with the others (every
run, then again in reverse order) beside ``torch.addmm(...,
out_dtype=float32)``, in a CUDA graph, warm, as ``chip_smoke.py`` phase 3
times the kernel.  One diagnostic copy computes wrong numbers to show
where the time goes: ``no-steps*`` skips the walk over N (launch, cluster
barriers and reduction only).  Prints the card, then one line per run (the
plan's own marked ``*``) with its share of the byte bound.
"""

from __future__ import annotations

import ctypes
import pathlib
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

TILE = "constexpr int kThinTileH = 64;"
COLS = "constexpr int kThinCols = 8;"
COLS_ASSERT = 'static_assert(kThinCols == 8, "a thread loads 16 bytes of a row");'
LOAD8 = "template <>\nstruct ThinLoad<8> {"
# 4 columns a thread: an 8-byte load of a row, widened as ThinLoad<8> widens
LOAD4 = """template <>
struct ThinLoad<4> {
  using V = uint2;
  __device__ static void widen(const V& v, float* x) {
    x[0] = __uint_as_float(v.x << 16);
    x[1] = __uint_as_float(v.x & 0xffff0000u);
    x[2] = __uint_as_float(v.y << 16);
    x[3] = __uint_as_float(v.y & 0xffff0000u);
  }
};
"""
THREADS = "constexpr int kThinThreads = 256;"
UNROLL = "constexpr int kThinUnroll = 8;"
WALK = "  for (int t = s0; t < s1; t += kUnroll) {"
# name -> {text in the source: its replacement}; diagnostic ones end in "*"
VARIANTS = {
    "as built": {},
    "16-column tile": {TILE: "constexpr int kThinTileH = 16;"},
    "32-column tile": {TILE: "constexpr int kThinTileH = 32;"},
    "4 columns a thread": {COLS: "constexpr int kThinCols = 4;", COLS_ASSERT: "",
                           LOAD8: LOAD4 + LOAD8},
    "unroll 4": {UNROLL: "constexpr int kThinUnroll = 4;"},
    "unroll 16": {UNROLL: "constexpr int kThinUnroll = 16;"},
    "128 threads": {THREADS: "constexpr int kThinThreads = 128;"},
    "no-steps*": {WALK: "  for (int t = s0; t < s0; t += kUnroll) {"},
}
SHAPES = {"xlstm mfg,mig": (2048, 1024, 4), "N=1024": (1024, 1024, 4),
          "F=12": (1000, 200, 12), "F=5": (77, 136, 5)}
TOL = 2e-2


def build_variants():
    from repro_torch.kernels import build

    src = (build.CSRC / "wgrad_accum.cu").read_text()
    out = ROOT / "build" / "wgrad_thin_variants"
    out.mkdir(parents=True, exist_ok=True)
    nvcc, procs = build.find_nvcc(), {}
    for i, (name, edits) in enumerate(VARIANTS.items()):
        text = src
        for old, new in edits.items():
            if old not in text:
                raise SystemExit(f"wgrad_thin_variants.py: {name!r}: {old!r} is not in the source")
            text = text.replace(old, new)
        cu = out / f"v{i}.cu"
        cu.write_text(text)
        procs[name] = (out / f"libv{i}.so", subprocess.Popen(
            [nvcc, *build.NVCC_FLAGS, "-o", str(out / f"libv{i}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"wgrad_thin_variants.py: {name!r} did not build:\n{log}")
        lib = ctypes.CDLL(str(so))
        lib.wgrad_accum.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 3 + [
            ctypes.c_int] * 3 + [ctypes.c_void_p]
        lib.wgrad_accum.restype = ctypes.c_int
        libs[name] = lib
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("wgrad_thin_variants.py: no CUDA card")
    import chip_smoke as cs
    from repro_torch.kernels import wgrad_accum as wg
    from repro_torch.kernels.ref import wgrad_accum_ref

    libs = build_variants()
    cs.phase_card()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(1)
    failed = []
    for label, (n, h, f) in SHAPES.items():
        a = (torch.randn(n, h, generator=gen, device="cuda") * 0.5).to(torch.bfloat16)
        g = (torch.randn(n, f, generator=gen, device="cuda") * 0.5).to(torch.bfloat16)
        acc = torch.randn(h, f, generator=gen, device="cuda")
        path = wg.plan_launch(n, h, f, a.dtype, a.data_ptr(), g.data_ptr(), acc.data_ptr())
        if path != "thin":
            failed.append(f"{label} plans {path}")
            continue
        ref = wgrad_accum_ref(a, g, acc)
        plan = wg.plan_thin(n, h, f, sms)
        runs = [(name, plan.split) for name in libs]
        runs[1:1] = [("as built", split) for split in wg.FP32_SPLITS
                     if split != plan.split and split <= plan.k_steps]
        rows = {}
        for name, split in runs:
            lib, out = libs[name], acc.clone()

            def call(lib=lib, out=out, split=split, name=name):
                err = lib.wgrad_accum(a.data_ptr(), g.data_ptr(), out.data_ptr(), n, h, f, 3,
                                      plan.tile_f, split, torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"{name}, split {split}: CUDA error {err}")

            call()
            first = out.clone()
            out.copy_(acc)
            call()
            torch.cuda.synchronize()
            same = torch.equal(first.view(torch.int32), out.view(torch.int32))
            ok = name.endswith("*") or same and torch.allclose(out, ref, TOL, TOL)
            if not ok:
                failed.append(f"{label} {name} split {split}")
            rows[name, split] = dict(call=call, same=same, ok=ok, t=[],
                                     err=float((out - ref).abs().max()))
        for order in (list(rows), list(rows)[::-1]):
            for key in order:
                rows[key]["t"].append(cs.device_ms(rows[key]["call"]))
        lib_ms = [cs.device_ms(cs._library_wgrad(a, g, acc)) for _ in range(2)]
        bound, bound_by = cs.wgrad_bound_ms(n, h, f, torch.bfloat16)
        print(f"[thin-variants] {label} N={n} H={h} F={f}: plan {plan}, grid {plan.grid} "
              f"blocks of {plan.threads} threads; torch.addmm {lib_ms[0]:.5f}/{lib_ms[1]:.5f} "
              f"(twice, after the runs); bound {bound:.5f} ({bound_by})")
        for (name, split), r in rows.items():
            mark = "*" if (name, split) == ("as built", plan.split) else " "
            ms = sum(r["t"]) / 2
            print(f"[thin-variants] {label} {mark} {name}, split {split}: device ms {ms:.5f} "
                  f"({'/'.join(f'{t:.5f}' for t in r['t'])}), {bound / ms:.1%} of the bound, "
                  f"{sum(lib_ms) / 2 / ms:.2f}x addmm's speed; max_abs_err {r['err']:.3g}; two "
                  f"launches bit for bit: {r['same']}{'' if r['ok'] else '  FAILED'}")
        del a, g, acc, ref, rows
        torch.cuda.empty_cache()
    if failed:
        print(f"[thin-variants] FAILED: {', '.join(failed)}")
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
