#!/usr/bin/env python3
"""The sLSTM time loop's kernels built in other layouts, on one CUDA card.

    PYTHONPATH=src python3 tools/slstm_variants.py

Copies ``csrc/slstm_scan.cu`` with one or more of its layout constants
changed (``VARIANTS``: the channels a block, the steps a chunk, the ring
depths, the warps a block; each within the 227 KB of shared memory a
block may hold: 16 channels only at 32-step chunks, and no chunk of 128
steps, whose backward slot is 41 KB), builds each copy with
the repo's nvcc flags into ``build/slstm_variants/``, all at once, and
runs each at xlstm-350m's
training shape (1, 2048, 1024) and its serving's ragged prefill (2, 513,
1024) against the plain loop (``kernels/ref.py::slstm_scan_ref``, run once
a shape): h, c, n, m bit for bit, di, df, dz within 1e-5 of the largest,
two launches bit for bit.  Then at the training shape each copy's forward
and forward + backward device times, in turns (every copy, then again in
reverse order), in a CUDA graph of 20 calls, as ``chip_smoke.py`` phase 3
times the kernels, beside the bound of ``chip_smoke.py::slstm_bound_ms``
and the design's own byte floor (17 arrays).  One diagnostic copy computes
wrong numbers to show where the time goes: ``no-chains*`` leaves the chain
warps idle (the loads, the workers' stages and the stores alone).
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

CHANNELS = "constexpr int kChannels = 8;"
CHUNK = "constexpr int kChunk = 64;"
FWD_RING = "constexpr int kFwdRing = 12;"
BWD_RING = "constexpr int kBwdRing = 8;"
WARPS = "constexpr int kWarps = 16;"
CHAINS = ("if (lane < kChannels && j < chunks) {",
          "if (lane < kChannels && k >= 0 && k < chunks) {",
          "if (lane < kChannels && u >= 0 && u < chunks) {")
# name -> {text in the source: its replacement}; diagnostic ones end in "*"
VARIANTS = {
    "as built": {},
    "16 channels, chunk 32": {CHANNELS: "constexpr int kChannels = 16;",
                              CHUNK: "constexpr int kChunk = 32;"},
    "chunk 32": {CHUNK: "constexpr int kChunk = 32;"},
    "chunk 96": {CHUNK: "constexpr int kChunk = 96;", BWD_RING: "constexpr int kBwdRing = 6;"},
    "rings 8, 6": {FWD_RING: "constexpr int kFwdRing = 8;",
                   BWD_RING: "constexpr int kBwdRing = 6;"},
    "rings 16, 9": {FWD_RING: "constexpr int kFwdRing = 16;",
                    BWD_RING: "constexpr int kBwdRing = 9;"},
    "8 warps": {WARPS: "constexpr int kWarps = 8;"},
    "24 warps": {WARPS: "constexpr int kWarps = 24;"},
    "no-chains*": {c: "if (false) {" for c in CHAINS},
}
SHAPES = ((1, 2048, 1024), (2, 513, 1024))
GRAD_RTOL = 1e-5


def build_variants():
    from repro_torch.kernels import build

    src = (build.CSRC / "slstm_scan.cu").read_text()
    out = ROOT / "build" / "slstm_variants"
    out.mkdir(parents=True, exist_ok=True)
    nvcc, procs = build.find_nvcc(), {}
    for i, (name, edits) in enumerate(VARIANTS.items()):
        text = src
        for old, new in edits.items():
            if old not in text:
                raise SystemExit(f"slstm_variants.py: {name!r}: {old!r} is not in the source")
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
            raise SystemExit(f"slstm_variants.py: {name!r} did not build:\n{log}")
        if name == "as built":
            print("\n".join(f"[slstm-variants] ptxas: {line.strip()}" for line in log.splitlines()
                            if "registers" in line or "spill" in line))
        lib = ctypes.CDLL(str(so))
        lib.slstm_fwd.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        lib.slstm_bwd.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        lib.slstm_fwd.restype = lib.slstm_bwd.restype = ctypes.c_int
        libs[name] = lib
    return libs


def _runner(lib, name, ins, dh):
    """(forward, forward + backward) calls of one library on fixed inputs
    and outputs: the forward writes h, c, n, m, the backward di, df, dz."""
    b, s, h = ins[0].shape
    outs = [torch.empty_like(ins[0]) for _ in range(7)]
    ptr = [t.data_ptr() for t in (*ins, *outs, dh)]

    def fwd(keep=(ins, dh, outs)):  # the tensors behind the raw pointers stay alive
        err = lib.slstm_fwd(*ptr[:3], *ptr[3:7], b, s, h, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{name} forward: CUDA error {err}")

    def both():
        fwd()
        err = lib.slstm_bwd(*ptr[:3], *ptr[4:7], ptr[10], *ptr[7:10], b, s, h,
                            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{name} backward: CUDA error {err}")

    return fwd, both, outs


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("slstm_variants.py: no CUDA card")
    import chip_smoke as cs
    from repro_torch.kernels.ref import slstm_scan_ref

    libs = build_variants()
    cs.phase_card()
    failed, timed = [], {}
    for shape in SHAPES:
        gen = torch.Generator(device="cuda").manual_seed(4)
        ins = [(torch.randn(shape, generator=gen, device="cuda") * sc).contiguous()
               for sc in (1.5, 1.5, 0.8)]
        dh = torch.randn(shape, generator=gen, device="cuda")
        xs = [t.clone().requires_grad_(True) for t in ins]
        hs, state = slstm_scan_ref(*xs)
        hs.backward(dh)
        want = [hs.detach(), *(t.detach() for t in state)]
        grads = [x.grad for x in xs]
        scale = max(float(g.abs().max()) for g in grads)
        for name, lib in libs.items():
            fwd, both, outs = _runner(lib, name, ins, dh)
            both()
            first = [t.clone() for t in outs]
            both()
            torch.cuda.synchronize()
            same = all(torch.equal(x, y) for x, y in zip(first, outs))
            got = [outs[0], *(t[:, -1] for t in outs[1:4])]
            exact = all(torch.equal(x, y) for x, y in zip(got, want))
            err = max(float((x - y).abs().max()) for x, y in zip(outs[4:], grads))
            ok = name.endswith("*") or same and exact and err <= GRAD_RTOL * scale
            if not ok:
                failed.append(f"{shape} {name}")
            print(f"[slstm-variants] {shape} {name}: h c n m bit for bit {exact}; di df dz "
                  f"max_abs_err {err:.3g} of max {scale:.3g}; two launches bit for bit {same}"
                  f"{'' if ok else '  FAILED'}")
            if shape == SHAPES[0]:
                timed[name] = (fwd, both, [], [])
            else:
                del outs
        del ins, dh, xs, hs, state, want, grads
    for order in (list(timed), list(timed)[::-1]):
        for name in order:
            fwd, both, tf, tb = timed[name]
            tf.append(cs.device_ms(fwd, iters=20))
            tb.append(cs.device_ms(both, iters=20))
    bound, bound_by, parts = cs.slstm_bound_ms(*SHAPES[0])
    b, s, h = SHAPES[0]
    floor = 17 * b * s * h * 4 / cs.HBM_BYTES_PER_S * 1e3
    print(f"[slstm-variants] {SHAPES[0]}: bound {bound:.4f} ms ({bound_by}: "
          + ", ".join(f"{k} {v:.4f}" for k, v in parts.items())
          + f"); the design's byte floor (17 arrays once) {floor:.4f} ms")
    for name, (_, _, tf, tb) in timed.items():
        ms = sum(tb) / 2
        print(f"[slstm-variants] {SHAPES[0]} {name}: forward + backward {ms:.4f} ms "
              f"({'/'.join(f'{t:.4f}' for t in tb)}), forward {sum(tf) / 2:.4f} "
              f"({'/'.join(f'{t:.4f}' for t in tf)}); {bound / ms:.1%} of the bound, "
              f"{floor / ms:.1%} of the byte floor")
    if failed:
        print(f"[slstm-variants] FAILED: {', '.join(failed)}")
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
