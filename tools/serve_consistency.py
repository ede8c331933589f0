#!/usr/bin/env python3
"""Decode-vs-prefill consistency of serving in bf16, in both packages.

    PYTHONPATH=src python3 tools/serve_consistency.py     # on the CPU, ~1 min

``chip_smoke.py`` holds the port's full-width bf16 serving to a limit on
the relative L2 gap between decoding token s after a prefill of s tokens and
the last position of a prefill of s + 1 tokens.  This script asks whether
that gap is bf16 rounding that the JAX package shows too: for each arch
(internlm2_1_8b, gemma2_2b) at reduced width in bf16, at the reduced depth
and at the full depth, with one set of weights (the JAX ``init_params``,
carried over bit for bit), it measures the gap in the JAX package (its
``make_serve_chunk`` stage by stage) and in the port (``launch.serve``),
over several seeds, and prints one JSON line per case.  gemma2's prompt is
two whole windows, where the JAX ring cache is right.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import get_reduced as jax_get_reduced  # noqa: E402
from repro.core.schedules.ir import Placement as JaxPlacement  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import modules as jmod  # noqa: E402
from repro.models import serve as jserve  # noqa: E402

from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.launch.serve import serve  # noqa: E402

P, M, B, PROMPT = 2, 2, 2, 16
SEEDS = (0, 1, 2)


def _jax_serve(cfg, stacked, shared, prompts, new_tokens):
    """Logits (m, b, V) in f32 and greedy tokens (m, b) of the prefill and of
    each decode step: the JAX ``make_serve_chunk`` applied stage by stage."""
    m, b, s = prompts.shape
    spec = jlm.RunSpec(p=P, n_chunks=1, microbatch=b, seq_len=s, m=m)
    pre, cache_init, _ = jserve.make_serve_chunk(cfg, spec, "prefill")
    dec, _, _ = jserve.make_serve_chunk(cfg, spec, "decode")
    pre, dec = jax.jit(pre), jax.jit(dec)
    ctx = jmod.ShardCtx()
    params = [jax.tree_util.tree_map(lambda a: a[st], stacked[0]) for st in range(P)]
    caches = [[cache_init(b, s + new_tokens) for _ in range(P)] for _ in range(m)]
    out, picked, toks = [], [], [None] * m
    for i in range(new_tokens + 1):
        step = []
        for j in range(m):
            tok = jnp.asarray(prompts[j]) if i == 0 else toks[j][:, None]
            x = jlm._embed_lookup(shared, tok, cfg, ctx)
            for st in range(P):
                if i == 0:
                    x, caches[j][st] = pre(params[st], x, {"positions": jnp.arange(s)},
                                           caches[j][st], 0)
                else:
                    x, caches[j][st] = dec(params[st], x, {}, caches[j][st], s + i - 1)
            lg = (jmod.rmsnorm(shared["final_ln"], x[:, -1:]) @ shared["head"])[:, 0]
            toks[j] = jnp.argmax(lg, -1)
            step.append(np.asarray(lg.astype(jnp.float32)))
        out.append(np.stack(step))
        picked.append(np.stack([np.asarray(t) for t in toks]))
    return out, picked


def _gap(dec, ref):
    return float(np.linalg.norm(dec - ref) / np.linalg.norm(ref)), float(np.abs(dec - ref).max())


def one_case(arch: str, n_layers: int, seed: int) -> dict:
    replace = dict(dtype="bfloat16", n_layers=n_layers)
    cfg_j = dataclasses.replace(jax_get_reduced(arch), **replace)
    cfg_t = dataclasses.replace(get_reduced(arch), **replace)
    spec = jlm.RunSpec(p=P, n_chunks=1, microbatch=B, seq_len=PROMPT, m=M)
    stacked_j, shared_j = jlm.init_params(cfg_j, spec, JaxPlacement.linear(P),
                                          key=jax.random.PRNGKey(seed))
    np_tree = jax.tree_util.tree_map(np.asarray, (stacked_j, shared_j))
    stacked_t, shared_t = params_from_numpy(*np_tree, device="cpu")
    prompts = np.random.default_rng(seed).integers(0, cfg_t.vocab, (M, B, PROMPT))

    jax_run, jax_tok = _jax_serve(cfg_j, stacked_j, shared_j, prompts, 1)
    jax_tok = jax_tok[0]  # the prefill's token, which decode step 1 reads
    jax_longer = np.concatenate([prompts, jax_tok[..., None]], axis=-1)
    jax_ref, _ = _jax_serve(cfg_j, stacked_j, shared_j, jax_longer, 0)
    port_run = serve(cfg_t, stacked_t, shared_t, prompts, p=P, new_tokens=1)
    port_tok = port_run.tokens[..., 0].numpy()
    port_longer = np.concatenate([prompts, port_tok[..., None]], axis=-1)
    port_ref = serve(cfg_t, stacked_t, shared_t, port_longer, p=P, new_tokens=0)

    jax_rel, jax_max = _gap(jax_run[1], jax_ref[0])
    port_dec = port_run.logits[1].float().numpy()
    port_rel, port_max = _gap(port_dec, port_ref.logits[0].float().numpy())
    return dict(arch=arch, n_layers=n_layers, sublayers=2 * n_layers, seed=seed, prompt=PROMPT,
                same_next_token=bool((jax_tok == port_tok).all()),
                jax_rel_l2=jax_rel, jax_max_abs=jax_max, port_rel_l2=port_rel,
                port_max_abs=port_max,
                port_vs_jax_decode_rel_l2=_gap(port_dec, jax_run[1])[0])


def main() -> int:
    torch.manual_seed(0)
    for arch in ("internlm2_1_8b", "gemma2_2b"):
        for n_layers in (get_reduced(arch).n_layers, jax_get_config(arch).n_layers):
            rows = [one_case(arch, n_layers, seed) for seed in SEEDS]
            for row in rows:
                print(json.dumps(row))
            print(json.dumps(dict(
                arch=arch, n_layers=n_layers, seeds=len(rows),
                jax_rel_l2_mean=float(np.mean([r["jax_rel_l2"] for r in rows])),
                port_rel_l2_mean=float(np.mean([r["port_rel_l2"] for r in rows])))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
