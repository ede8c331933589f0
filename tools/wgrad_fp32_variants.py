#!/usr/bin/env python3
"""``wgrad_accum``'s fp32 kernel built in other layouts, on one CUDA card.

    PYTHONPATH=src python3 tools/wgrad_fp32_variants.py

Copies ``csrc/wgrad_accum.cu`` with one or more of its layout constants
changed (``VARIANTS``: the tile's rows and a stage's rows at every width,
the ring's stages), builds each copy with the repo's nvcc flags into
``build/wgrad_fp32_variants/``, all at once, and at the fp32 shapes of
``chip_smoke.py`` phase 3 (the two routers, the square, the reduced
model's and a ragged one) runs the source as built under the plan
``plan_fp32`` picks and under every other split of N the plan's steps
allow, and each copy under the plan's split.  Each run: its error against
the plain version and an fp64 sum (at the plan's split within 1e-5 of one
of them), two launches bit for bit, and its device time in turns with the others (every
run, then again in reverse order) beside ``torch.addmm(...,
out_dtype=float32)``, in a CUDA graph, warm, as phase 3 times the kernel.
Three diagnostic copies take a part out to show where the time goes, and
compute wrong numbers: ``no-loads`` (the ring is never filled), ``no-fma``
(one FMA a row of a stage instead of 32 or 64) and ``no-steps`` (the walk
over N skipped: launch, barriers, reduction).  Prints the card, then per
shape how far the plain version is from an fp64 sum and where that sum,
rounded to fp32, sits against phase 3's 1e-5 limit around the plain
version, and one line per run (the plan's own marked ``*``).
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

TILE_H = "constexpr int kF32TileHs[4] = {128, 64, 64, 128};"
BK = "constexpr int kF32BKs[4] = {16, 32, 32, 16};"
STAGES = "constexpr int kF32Stages = 4;"
LOAD_FIRST = "    if (t < steps) load(t);"
LOAD_NEXT = "    if (t + kF32Stages - 1 < steps) load(t + kF32Stages - 1);  // into step t - 1's stage"
FMA = "        for (int j = 0; j < T::kTN; ++j) c[i][j] = fmaf(av[i], gv[j], c[i][j]);"
STEPS = "  const int steps = s1 - s0;"
# name -> {text in the source: its replacement}; diagnostic ones end in "*"
VARIANTS = {
    "as built": {},
    "128x16 everywhere": {TILE_H: "constexpr int kF32TileHs[4] = {128, 128, 128, 128};",
                          BK: "constexpr int kF32BKs[4] = {16, 16, 16, 16};"},
    "64-row tiles everywhere": {TILE_H: "constexpr int kF32TileHs[4] = {64, 64, 64, 64};"},
    "32-row steps everywhere": {BK: "constexpr int kF32BKs[4] = {32, 32, 32, 32};"},
    "3 stages": {STAGES: "constexpr int kF32Stages = 3;"},
    "8 stages": {STAGES: "constexpr int kF32Stages = 8;"},
    "no-loads*": {LOAD_FIRST: "", LOAD_NEXT: ""},
    "no-fma*": {FMA: "        if (i == 0) c[0][0] = fmaf(av[0] + av[7], gv[0] + gv[T::kTN - 1], c[0][0]);"},
    "no-steps*": {STEPS: "  const int steps = 0;"},
}
SHAPES = {"qwen2-moe router": (1024, 2048, 60), "deepseek router": (1024, 7168, 16),
          "fp32": (1024, 2048, 2048), "reduced": (64, 48, 96), "ragged-fp32": (77, 129, 257)}
TOL = 1e-5


def build_variants():
    from repro_torch.kernels import build

    src = (build.CSRC / "wgrad_accum.cu").read_text()
    out = ROOT / "build" / "wgrad_fp32_variants"
    out.mkdir(parents=True, exist_ok=True)
    nvcc, procs = build.find_nvcc(), {}
    for i, (name, edits) in enumerate(VARIANTS.items()):
        text = src
        for old, new in edits.items():
            if old not in text:
                raise SystemExit(f"wgrad_fp32_variants.py: {name!r}: {old!r} is not in the source")
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
            raise SystemExit(f"wgrad_fp32_variants.py: {name!r} did not build:\n{log}")
        lib = ctypes.CDLL(str(so))
        lib.wgrad_accum.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 3 + [
            ctypes.c_int] * 3 + [ctypes.c_void_p]
        lib.wgrad_accum.restype = ctypes.c_int
        libs[name] = lib
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("wgrad_fp32_variants.py: no CUDA card")
    import chip_smoke as cs
    from repro_torch.kernels import wgrad_accum as wg
    from repro_torch.kernels.ref import wgrad_accum_ref

    torch.backends.cuda.matmul.allow_tf32 = False
    libs = build_variants()
    cs.phase_card()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(1)
    failed = []
    for label, (n, h, f) in SHAPES.items():
        a = torch.randn(n, h, generator=gen, device="cuda") * 0.5
        g = torch.randn(n, f, generator=gen, device="cuda") * 0.5
        acc = torch.randn(h, f, generator=gen, device="cuda")
        ref = wgrad_accum_ref(a, g, acc)
        ref64 = acc.double() + a.double().t() @ g.double()
        plan = wg.plan_fp32(n, h, f, sms)
        runs = [(name, plan.split) for name in libs]
        runs[1:1] = [("as built", split) for split in wg.FP32_SPLITS
                     if split != plan.split and split <= plan.k_steps]
        rows = {}
        for name, split in runs:
            lib, out = libs[name], acc.clone()

            def call(lib=lib, out=out, split=split):
                err = lib.wgrad_accum(a.data_ptr(), g.data_ptr(), out.data_ptr(), n, h, f, 0,
                                      plan.tile_f, split, torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"{name}, split {split}: CUDA error {err}")

            call()
            first = out.clone()
            out.copy_(acc)
            call()
            torch.cuda.synchronize()
            same = torch.equal(first.view(torch.int32), out.view(torch.int32))
            # the plan's split sums in the plan's order, held at 1e-5; the
            # other splits sum longer or shorter runs and are only printed
            ok = name.endswith("*") or same and (split != plan.split or (
                torch.allclose(out, ref, TOL, TOL) or torch.allclose(out.double(), ref64, TOL, TOL)))
            if not ok:
                failed.append(f"{label} {name} split {split}")
            rows[name, split] = dict(call=call, same=same, ok=ok, t=[],
                                     err=float((out - ref).abs().max()),
                                     err64=float((out - ref64).abs().max()))
        for order in (list(rows), list(rows)[::-1]):
            for key in order:
                rows[key]["t"].append(cs.device_ms(rows[key]["call"]))
        lib_ms = cs.device_ms(cs._library_wgrad(a, g, acc))
        bound, bound_by = cs.wgrad_bound_ms(n, h, f, torch.float32)
        exact = ref64.float()  # the best an fp32 result can be
        print(f"[fp32-variants] {label} N={n} H={h} F={f}: the plain version is "
              f"{float((ref - ref64).abs().max()):.3g} from an fp64 sum; that sum rounded to fp32 "
              f"sits at {float(((exact - ref).abs() / (TOL + TOL * ref.abs())).max()):.3f} of "
              f"the {TOL} limit against the plain version")
        for (name, split), r in rows.items():
            mark = "*" if (name, split) == ("as built", plan.split) else " "
            ms = sum(r["t"]) / 2
            print(f"[fp32-variants] {label} N={n} H={h} F={f} {mark} {name}, "
                  f"{plan.tile_f}-column tile, split {split}: device ms {ms:.5f} "
                  f"({'/'.join(f'{t:.5f}' for t in r['t'])}), torch.addmm {lib_ms:.5f}, bound "
                  f"{bound:.5f} ({bound_by}); max_abs_err {r['err']:.3g} against the plain "
                  f"version, {r['err64']:.3g} against an fp64 sum; two launches bit for bit: "
                  f"{r['same']}{'' if r['ok'] else '  FAILED'}")
        del a, g, acc, ref, ref64, rows
        torch.cuda.empty_cache()
    if failed:
        print(f"[fp32-variants] FAILED: {', '.join(failed)}")
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
