"""Pipelined serving: prefill a batch of requests, then decode tokens.

  python -m repro_torch.examples.serve_pipeline [--device cuda|cpu]

Counterpart of ``examples/serve_pipeline.py``: reduced internlm2 on P_ = 4
linear stages, all on one device (``--device``, the CUDA card by default;
it raises when there is none), M_ = 8 request groups of B_ = 2 sequences,
a cache of S_CTX = 32 positions: a prefill of S_CTX - N_NEW tokens, then
N_NEW greedy decode steps, each through ``launch/steps.py::build_serve_step``.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..configs import get_reduced
from ..core.schedules.ir import Placement
from ..launch.serve import _sync, resolve_device
from ..launch.steps import build_serve_step
from ..models.lm import RunSpec, init_params, side_inputs

__all__ = ["P_", "M_", "B_", "S_CTX", "N_NEW", "generate", "main"]

P_, M_, B_, S_CTX, N_NEW = 4, 8, 2, 32, 8
ARCH = "internlm2_1_8b"


def generate(device, params=None, tokens: Optional[np.ndarray] = None, log=print) -> Dict:
    """Prefill ``tokens`` (M_, B_, S_CTX - N_NEW), then N_NEW greedy decode
    steps, on ``device``; ``params`` (stacked, shared) and ``tokens`` default
    to the port's seed-0 weights and its seeded side inputs.  Returns
    ``logits`` (N_NEW + 1 steps of (M_, B_, V)) and ``tokens`` (M_, B_,
    N_NEW + 1): the greedy token after the prompt and after each step."""
    device = torch.device(device)
    cfg = get_reduced(ARCH)
    placement = Placement.linear(P_)
    spec = RunSpec(p=P_, n_chunks=1, microbatch=B_, seq_len=S_CTX - N_NEW, m=M_)
    stacked, shared = params if params is not None else init_params(cfg, spec, placement,
                                                                   device=device)
    tokens = tokens if tokens is not None else side_inputs(cfg, spec)["tokens"]

    # ---- prefill: build caches for m request groups -------------------- #
    prefill, _, cache_init = build_serve_step(cfg, spec, placement, "prefill")
    caches = [cache_init(B_, S_CTX, device=device, lead=(P_, M_))]
    side = {"tokens": torch.as_tensor(np.array(tokens), dtype=torch.long, device=device),
            "positions": torch.arange(spec.seq_len, device=device).expand(M_, spec.seq_len)}
    _sync(device)
    t0 = time.time()
    logits, caches = prefill(stacked, shared, side, caches, 0)
    _sync(device)
    log(f"prefill: {M_} groups x {B_} seqs x {spec.seq_len} tokens "
        f"in {time.time() - t0:.2f}s; logits {tuple(logits.shape)}")

    # ---- decode: N_NEW pipelined single-token steps -------------------- #
    decode, _, _ = build_serve_step(cfg, dataclasses.replace(spec, seq_len=1), placement,
                                    "decode")
    toks = torch.argmax(logits, -1)  # greedy next token per sequence
    out_logits, out_tokens = [logits], [toks]
    for i in range(N_NEW):
        dside = {"tokens": toks[..., None],
                 "positions": torch.zeros((M_, 1), dtype=torch.long, device=device)}
        t0 = time.time()
        logits, caches = decode(stacked, shared, dside, caches, spec.seq_len + i)
        toks = torch.argmax(logits, -1)
        _sync(device)
        out_logits.append(logits)
        out_tokens.append(toks)
        log(f"decode step {i}: {M_ * B_} tokens in {time.time() - t0:.3f}s")
    return {"logits": out_logits, "tokens": torch.stack(out_tokens, -1)}


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = generate(resolve_device(args.device))
    print("generated:", out["tokens"][0, 0].tolist())
    print("OK")
    return out


if __name__ == "__main__":
    main()
