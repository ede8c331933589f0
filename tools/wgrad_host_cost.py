#!/usr/bin/env python3
"""Host time of one eager ``wgrad_accum_cuda`` call, for whichever
``repro_torch`` is first on the import path.

    PYTHONPATH=<checkout>/src python3 tools/wgrad_host_cost.py

Times, on one CUDA card, the enqueue alone (no device sync inside the
window) of ``repro_torch.kernels.wgrad_accum.wgrad_accum_cuda`` at the four
W shapes of the full-width internlm2-1.8b training step (N = 1024, bf16 a
and g, fp32 acc), and prints one JSON line: the package's path, the card,
and per shape the median of 5 windows of 200 calls, in microseconds.
``chip_smoke.py`` reads the same cost for its own checkout; this script
exists to compare two checkouts' wrappers in one session, in turns
(A, B, B, A): both take ``(a, g, acc)``, whatever they return.
"""

from __future__ import annotations

import json
import statistics
import time

import torch

SHAPES = {"wq,wo": (1024, 2048, 2048), "wk,wv": (1024, 2048, 1024),
          "wu,wg": (1024, 2048, 8192), "wd": (1024, 8192, 2048)}
CALLS, WINDOWS = 200, 5


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("wgrad_host_cost.py: no CUDA card")
    from repro_torch.kernels import wgrad_accum as wg

    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {"package": wg.__file__, "card": torch.cuda.get_device_name(0),
           "host_us_per_call": {}}
    for name, (n, h, f) in SHAPES.items():
        a = torch.randn(n, h, generator=gen, device="cuda").to(torch.bfloat16)
        g = torch.randn(n, f, generator=gen, device="cuda").to(torch.bfloat16)
        acc = torch.zeros(h, f, device="cuda")
        wg.wgrad_accum_cuda(a, g, acc)  # build, load, warm up
        torch.cuda.synchronize()
        windows = []
        for _ in range(WINDOWS):
            t0 = time.perf_counter()
            for _ in range(CALLS):
                wg.wgrad_accum_cuda(a, g, acc)
            windows.append((time.perf_counter() - t0) / CALLS * 1e6)
            torch.cuda.synchronize()
        out["host_us_per_call"][name] = statistics.median(windows)
        del a, g, acc
        torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
