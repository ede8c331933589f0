#!/usr/bin/env python3
"""The RMSNorm kernel's ``bulk`` path under other launch plans, on one CUDA card.

    PYTHONPATH=src python3 tools/rmsnorm_plans.py

At the main path's bulk shapes (bf16: internlm2's (1024, 2048), gpt3-1.5b's
(1024, 2304), gemma2-2b's prefill (4100, 2304)), holds each plan's output
against the plain version and times it in turns against ``F.rms_norm``
(kernel, library, library, kernel), warm (inputs in L2) and cold (x and y
rotated past the L2), as ``chip_smoke.py`` phase 3 times the default plan.
The plans (``VARIANTS``): one or two blocks an SM, a ring of 8 or of up
to 16 stages, one warp a row or two.  Prints the card, then one line
per shape and plan (the default marked ``*``).
"""

from __future__ import annotations

import pathlib
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

# (blocks an SM, stages at most, warps a row or 0 for the plan's own)
VARIANTS = ((2, 16, 0), (2, 16, 1), (2, 16, 2), (1, 16, 0), (2, 8, 0))
SHAPES = {"internlm2 (1024, 2048)": (1024, 2048), "gpt3 (1024, 2304)": (1024, 2304),
          "gemma2 prefill (4100, 2304)": (4100, 2304)}


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("rmsnorm_plans.py: no CUDA card")
    import chip_smoke as cs
    from repro_torch.kernels import rmsnorm as rk
    from repro_torch.kernels.ref import rmsnorm_ref

    cs.phase_card()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(0)
    for label, (n, h) in SHAPES.items():
        x = torch.randn(n, h, generator=gen, device="cuda").to(torch.bfloat16)
        g = (torch.randn(h, generator=gen, device="cuda") * 0.5).to(torch.bfloat16)
        w = (1.0 + g.float()).to(x.dtype)
        default = rk.plan_launch(n, h, x.dtype, g.dtype, x.data_ptr(), 0, sms)
        ref = rmsnorm_ref(x, g).float()
        bound, _ = cs.rmsnorm_bound_ms(n, h, x.dtype, g.dtype)
        library_of = lambda a: torch.nn.functional.rms_norm(a, (h,), w, 1e-6)  # noqa: E731
        for per_sm, max_stages, wpr in VARIANTS:
            plan = rk.bulk_plan(n, h, 2, sms, per_sm, max_stages, wpr)

            def kernel_of(a, plan=plan):
                y = torch.empty_like(a)
                rk.launch(a, g, y, 1e-6, plan)
                return y

            got = kernel_of(x)
            torch.cuda.synchronize()
            torch.testing.assert_close(got.float(), ref, rtol=2e-2, atol=2e-2)
            ms, lib_ms, _ = cs.in_turns(lambda: kernel_of(x), lambda: library_of(x))
            kernel_cold, k = cs.rotated(kernel_of, x, x.numel() * 2)
            library_cold, _ = cs.rotated(library_of, x, x.numel() * 2)
            cold, lib_cold, _ = cs.in_turns(kernel_cold, library_cold, iters=k * -(-100 // k))
            print(f"[plans] {label} {'*' if plan == default else ' '} blocks/SM {per_sm} grid "
                  f"{plan.grid} stages {plan.stages} warps/row {plan.warps_per_row}: "
                  f"warm {ms:.5f} ms "
                  f"(F.rms_norm {lib_ms:.5f}), cold {cold:.5f} ms (F.rms_norm {lib_cold:.5f}, "
                  f"kernel at {bound / cold:.1%} of the {bound:.5f} ms bound)", flush=True)
            del kernel_cold, library_cold
    return 0


if __name__ == "__main__":
    sys.exit(main())
