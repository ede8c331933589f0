#!/usr/bin/env python3
"""The rounding error of ``wgrad_accum``'s fp32 path at the routers' shapes,
replayed on the CPU.

    PYTHONPATH=src python3 tools/wgrad_fp32_error.py

Replays in numpy the kernel's order of fp32 operations under a plan of
``plan_fp32`` (each of ``split`` slices of N summed by one ``fmaf`` chain
an output, the partials added in rank order, then added to acc once), and
a split-K product of 32 slices that stands in for cuBLAS.  For the qwen2-moe
router (1024; 2048, 60) and the deepseek-v3 cut's (1024; 7168, 16), inputs
drawn as ``chip_smoke.py`` phase 3 draws them (a, g ~ N(0, 0.25), acc ~
N(0, 1)), prints per split each one's largest error against an fp64 sum
and the worst ratios |kernel - x| / (1e-5 + 1e-5 |x|) for x the fp64 sum
and the plain product, which phase 3's ``assert_close`` holds at or
under 1.  An ``fmaf`` is one
rounding of the exact a*g + c, replayed as a float64 sum rounded to float32
(a product of two float32 is exact in float64).  A CPU estimate, not the
card's: phase 3 prints the card's errors.
"""

from __future__ import annotations

import numpy as np

SHAPES = {"qwen2-moe router": (1024, 2048, 60), "deepseek router": (1024, 7168, 16)}
SPLITS = (1, 4, 8)
BK, PLAIN_SPLIT, TOL = 16, 32, 1e-5


def replay(a, g, acc, split):
    """acc + a^T g summed as the fp32 kernel sums it under ``split``."""
    n = a.shape[0]
    k = -(-n // BK)
    parts = []
    for r in range(split):
        s0, s1 = r * k // split * BK, min(n, (r + 1) * k // split * BK)
        c = np.zeros((a.shape[1], g.shape[1]), np.float32)
        for i in range(s0, s1):
            c = (c + np.outer(a[i].astype(np.float64), g[i])).astype(np.float32)
        parts.append(c)
    s = parts[0]
    for p in parts[1:]:
        s = s + p  # float32 + float32: one rounding
    return acc + s


def main() -> int:
    for label, (n, h, f) in SHAPES.items():
        rng = np.random.default_rng(1)
        a = (rng.standard_normal((n, h)) * 0.5).astype(np.float32)
        g = (rng.standard_normal((n, f)) * 0.5).astype(np.float32)
        acc = rng.standard_normal((h, f)).astype(np.float32)
        exact = acc.astype(np.float64) + a.astype(np.float64).T @ g.astype(np.float64)
        plain = replay(a, g, acc, PLAIN_SPLIT)
        for split in SPLITS:
            out = replay(a, g, acc, split)
            ratio = np.abs(out - plain) / (TOL + TOL * np.abs(plain))
            exact_ratio = np.abs(out - exact) / (TOL + TOL * np.abs(exact))
            print(f"[fp32-error] {label} N={n} H={h} F={f} split {split}: against an fp64 sum "
                  f"kernel {np.abs(out - exact).max():.3g} (worst |kernel - fp64| / tol "
                  f"{exact_ratio.max():.3f}), split-K plain {np.abs(plain - exact).max():.3g}; "
                  f"worst |kernel - plain| / tol {ratio.max():.3f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
