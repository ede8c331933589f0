"""Pipelined serving launcher of the port (prefill + greedy decode loop).

  python -m repro_torch.launch.serve --arch internlm2_1_8b \\
      --pipe-size 4 --groups 8 --batch 2 --prompt-len 512 --new-tokens 16

Runs on the CUDA card by default and raises when there is none; it never
carries on on the CPU unless ``--device cpu`` asks for it.  Weights are
random, drawn from ``--seed``; prompts come from ``numpy.random.default_rng
(seed)``, and after them, for the vlm and encdec families, the front's
embeddings (patches or frames, N(0, 1), cast to the model dtype).

The vlm front sits in the cache ahead of the prompt: the cache holds
``n_patches + prompt_len + new_tokens`` positions, the prefill runs at
positions ``[0, n_patches + prompt_len)`` and decode step i at ``n_patches +
prompt_len + i``.  (The JAX launcher sizes the cache as ``prompt_len +
new_tokens`` whatever the family, which for a vlm drops the patches' keys.)
An encdec model's front is its encoder stream, outside the decoder's cache:
the cache holds ``prompt_len + new_tokens`` decoder positions and decode
step i runs at ``prompt_len + i``.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from ..configs import get_config, get_reduced
from ..core.schedules.ir import Placement
from ..models.lm import ArchConfig, RunSpec, front_len, front_spec, init_params
from .steps import build_serve_step

__all__ = ["ServeResult", "serve", "resolve_device", "draw_front", "main"]


@dataclasses.dataclass
class ServeResult:
    logits: List[torch.Tensor]  # prefill's, then each decode step's: (m, b, V)
    tokens: torch.Tensor  # (m, b, new_tokens + 1) greedy tokens
    prefill_s: float  # host seconds, ending in a device synchronise
    decode_s: List[float]


def resolve_device(name: str) -> torch.device:
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA card and none is available; "
            "pass --device cpu to run the plain CPU path on purpose"
        )
    return dev


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def draw_front(cfg: ArchConfig, rng: np.random.Generator, m: int, b: int) -> Optional[np.ndarray]:
    """The front's embeddings of m groups of b requests, (m, b, n, width)
    float32 N(0, 1) from ``rng``; None for a family without a front."""
    front = front_spec(cfg)
    if front is None:
        return None
    return rng.standard_normal((m, b, front[1], front[2])).astype(np.float32)


@torch.inference_mode()
def serve(cfg: ArchConfig, stacked, shared, prompts: np.ndarray, *, p: int,
          new_tokens: int, front: Optional[np.ndarray] = None,
          log: Optional[Callable[[str], None]] = None) -> ServeResult:
    """Prefill ``prompts`` (m, b, s) through p linear stages, then decode
    ``new_tokens`` greedy steps.  Runs on the device of ``shared``.  A vlm
    or encdec model needs ``front`` (m, b, n, frontend_dim), cast to the
    model dtype: the patches or frames of each request."""
    device = shared["embed"].device
    m, b, s = prompts.shape
    placement = Placement.linear(p)
    spec = RunSpec(p=p, n_chunks=1, microbatch=b, seq_len=s, m=m)
    front_in = front_spec(cfg)
    n_front = front_len(cfg)
    cached = n_front if cfg.family == "vlm" else 0  # front positions in the cache
    prefill, _, cache_init = build_serve_step(cfg, spec, placement, "prefill")
    dspec = dataclasses.replace(spec, seq_len=1)
    decode, _, _ = build_serve_step(cfg, dspec, placement, "decode")
    caches = [cache_init(b, cached + s + new_tokens, device=device, lead=(p, m))]
    side = {
        "tokens": torch.as_tensor(prompts, dtype=torch.long, device=device),
        "positions": torch.arange(n_front + s, device=device).expand(m, n_front + s),
    }
    if front_in is not None:
        if front is None or tuple(front.shape[:3]) != (m, b, n_front):
            raise ValueError(f"{cfg.name} needs its front's embeddings (m, b, {n_front}, "
                             f"width); got {None if front is None else front.shape}")
        side[front_in[0]] = torch.as_tensor(front, device=device).to(cfg.torch_dtype())
    _sync(device)
    t0 = time.perf_counter()
    logits, caches = prefill(stacked, shared, side, caches, 0)
    _sync(device)
    prefill_s = time.perf_counter() - t0
    if log:
        log(f"prefill {m}x{b}x{s} tok: {prefill_s:.2f}s")

    out_logits = [logits]
    toks = [torch.argmax(logits, dim=-1)]
    decode_s = []
    for i in range(new_tokens):
        dside = {
            "tokens": toks[-1][..., None],
            "positions": torch.zeros((m, 1), dtype=torch.long, device=device),
        }
        t0 = time.perf_counter()
        logits, caches = decode(stacked, shared, dside, caches, cached + s + i)
        toks.append(torch.argmax(logits, dim=-1))
        _sync(device)
        decode_s.append(time.perf_counter() - t0)
        out_logits.append(logits)
        if log:
            log(f"decode step {i}: {m * b} tokens, {decode_s[-1]:.3f}s")
    return ServeResult(out_logits, torch.stack(toks, dim=-1), prefill_s, decode_s)


def main(argv: Optional[Sequence[str]] = None) -> ServeResult:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2_1_8b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--pipe-size", type=int, default=4)
    ap.add_argument("--groups", type=int, default=8)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--new-tokens", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    p, m, b = args.pipe_size, args.groups, args.batch
    spec = RunSpec(p=p, n_chunks=1, microbatch=b, seq_len=args.prompt_len, m=m)
    stacked, shared = init_params(cfg, spec, Placement.linear(p), seed=args.seed,
                                  device=device)
    rng = np.random.default_rng(args.seed)
    prompts = rng.integers(0, cfg.vocab, (m, b, args.prompt_len))
    res = serve(cfg, stacked, shared, prompts, p=p, new_tokens=args.new_tokens,
                front=draw_front(cfg, rng, m, b), log=print)
    print("OK")
    return res


if __name__ == "__main__":
    main()
