#!/usr/bin/env python3
"""Decode-vs-prefill consistency of serving in bf16, in both packages.

    PYTHONPATH=src python3 tools/serve_consistency.py [--moe | --recurrent]  # CPU, minutes
    PYTHONPATH=src python3 tools/serve_consistency.py --arch xlstm_350m 24 --seeds 10

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

The moe archs (qwen2_moe_a2_7b at 24 layers, 48 sublayers; deepseek_v3_671b
at the 2 layers its full-width serve runs, and at 24) run with the
capacity at the longer prefill's token count, so nothing drops, and each
case also counts the top-k flips of each package: the (moe layer, token)
top-k sets of the decode step that differ from those of the longer
prefill's last position (``*_flips`` of ``topk_sets``).  A port whose
flips far outnumber the JAX package's on the same weights has a fault of
its own; as many flips in both are the bf16 walk's.

The recurrent archs (``--recurrent``: xlstm_350m at its reduced 4 and its
full 24 layers, recurrentgemma_9b at its reduced 3 and its full 38, the
latter's prompt two whole windows) decode in the step form with fp32
state, where the prefill runs the chunkwise mLSTM (its memory in bf16,
its gates through ``log(f + 1e-6)``), the sLSTM loop and the RG-LRU's
associative scan: the gap measures how far the two forms part in bf16.
"""

from __future__ import annotations

import collections
import contextlib
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
from repro_torch.models import modules as tmod  # noqa: E402

P, M, B, PROMPT = 2, 2, 2, 16
SEEDS = (0, 1, 2)
MOE_CASES = (("qwen2_moe_a2_7b", 24), ("deepseek_v3_671b", 2), ("deepseek_v3_671b", 24))
RECURRENT_CASES = (("xlstm_350m", 4), ("xlstm_350m", 24), ("recurrentgemma_9b", 3),
                   ("recurrentgemma_9b", 38))


@contextlib.contextmanager
def _route_logs():
    """Each moe call's top-k choice: ``jax`` in call order (ordered
    callbacks from inside the jitted steps), ``port`` as (router address,
    choice)."""
    logs = {"jax": [], "port": []}
    real_j, real_t = jmod._moe_route, tmod._moe_route

    def jax_route(p, tok, cfg):
        out = real_j(p, tok, cfg)
        jax.debug.callback(lambda t: logs["jax"].append(np.asarray(t)), out[1], ordered=True)
        return out

    def port_route(p, tok, cfg):
        out = real_t(p, tok, cfg)
        logs["port"].append((p["router"].data_ptr(), out[1].numpy().copy()))
        return out

    jmod._moe_route, tmod._moe_route = jax_route, port_route
    try:
        yield logs
    finally:
        jmod._moe_route, tmod._moe_route = real_j, real_t
        jax.effects_barrier()


def _jax_by_layer(log, g, steps):
    """{layer: [choice of each call]}: ``_jax_serve`` calls step by step,
    group by group, stage by stage, block by block."""
    out = collections.defaultdict(list)
    it = iter(log)
    for _ in range(steps):
        for _ in range(M):
            for st in range(P):
                for bi in range(g):
                    out[st * g + bi].append(next(it))
    return out


def _port_by_layer(log, stacked, g):
    layer_of = {blk[1]["router"][st].data_ptr(): st * g + bi
                for bi, blk in enumerate(stacked[0]["blocks"]) for st in range(P)}
    out = collections.defaultdict(list)
    for ptr, top_i in log:
        out[layer_of[ptr]].append(top_i)
    return out


def _flips(run, ref, n_layers):
    """(layer, token) top-k sets of the decode step (the last M calls of
    each layer in ``run``) that differ from the longer prefill's last
    position (``ref``'s calls)."""
    n = 0
    for layer in range(n_layers):
        for dec, pre in zip(run[layer][-M:], ref[layer], strict=True):
            last = np.asarray(pre).reshape(B, PROMPT + 1, -1)[:, -1]
            n += int((np.sort(dec, -1) != np.sort(last, -1)).any(-1).sum())
    return n


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
    moe = "moe" in cfg_t.block_pattern[0]
    if moe:  # nothing drops: the longer prefill's tokens a capacity
        cap = (("capacity", B * (PROMPT + 1)),)
        cfg_j = dataclasses.replace(cfg_j, extras=cfg_j.extras + cap)
        cfg_t = dataclasses.replace(cfg_t, extras=cfg_t.extras + cap)
    spec = jlm.RunSpec(p=P, n_chunks=1, microbatch=B, seq_len=PROMPT, m=M)
    stacked_j, shared_j = jlm.init_params(cfg_j, spec, JaxPlacement.linear(P),
                                          key=jax.random.PRNGKey(seed))
    np_tree = jax.tree_util.tree_map(np.asarray, (stacked_j, shared_j))
    stacked_t, shared_t = params_from_numpy(*np_tree, device="cpu")
    prompts = np.random.default_rng(seed).integers(0, cfg_t.vocab, (M, B, PROMPT))

    logs = []
    with _route_logs() as log:
        jax_run, jax_tok = _jax_serve(cfg_j, stacked_j, shared_j, prompts, 1)
        logs.append(log)
    jax_tok = jax_tok[0]  # the prefill's token, which decode step 1 reads
    jax_longer = np.concatenate([prompts, jax_tok[..., None]], axis=-1)
    with _route_logs() as log:
        jax_ref, _ = _jax_serve(cfg_j, stacked_j, shared_j, jax_longer, 0)
        port_run = serve(cfg_t, stacked_t, shared_t, prompts, p=P, new_tokens=1)
        logs.append(log)
    port_tok = port_run.tokens[..., 0].numpy()
    port_longer = np.concatenate([prompts, port_tok[..., None]], axis=-1)
    with _route_logs() as log:
        port_ref = serve(cfg_t, stacked_t, shared_t, port_longer, p=P, new_tokens=0)
        logs.append(log)
    flips = {}
    if moe:
        g = n_layers // P
        flips = dict(
            topk_sets=n_layers * M * B,
            jax_flips=_flips(_jax_by_layer(logs[0]["jax"], g, 2),
                             _jax_by_layer(logs[1]["jax"], g, 1), n_layers),
            port_flips=_flips(_port_by_layer(logs[1]["port"], stacked_t, g),
                              _port_by_layer(logs[2]["port"], stacked_t, g), n_layers))

    jax_rel, jax_max = _gap(jax_run[1], jax_ref[0])
    port_dec = port_run.logits[1].float().numpy()
    port_rel, port_max = _gap(port_dec, port_ref.logits[0].float().numpy())
    period = cfg_t.block_pattern
    sublayers = sum(len(period[i % len(period)]) for i in range(n_layers))
    return dict(arch=arch, n_layers=n_layers, sublayers=sublayers, seed=seed, prompt=PROMPT,
                same_next_token=bool((jax_tok == port_tok).all()),
                jax_rel_l2=jax_rel, jax_max_abs=jax_max, port_rel_l2=port_rel,
                port_max_abs=port_max,
                port_vs_jax_decode_rel_l2=_gap(port_dec, jax_run[1])[0], **flips)


def main(argv=None) -> int:
    """``--moe`` runs only the moe cases, ``--recurrent`` only the recurrent
    ones, ``--arch NAME LAYERS`` one case; ``--seeds N`` seeds 0..N-1 (default
    3)."""
    torch.manual_seed(0)
    dense = [(arch, n) for arch in ("internlm2_1_8b", "gemma2_2b")
             for n in (get_reduced(arch).n_layers, jax_get_config(arch).n_layers)]
    args = argv or sys.argv[1:]
    cases = (list(MOE_CASES) if "--moe" in args else list(RECURRENT_CASES)
             if "--recurrent" in args else dense + list(MOE_CASES) + list(RECURRENT_CASES))
    if "--arch" in args:  # one arch at one depth: --arch NAME LAYERS
        i = args.index("--arch")
        cases = [(args[i + 1], int(args[i + 2]))]
    seeds = range(int(args[args.index("--seeds") + 1])) if "--seeds" in args else SEEDS
    for arch, n_layers in cases:
        rows = [one_case(arch, n_layers, seed) for seed in seeds]
        for row in rows:
            print(json.dumps(row), flush=True)
        summary = dict(arch=arch, n_layers=n_layers, seeds=len(rows),
                       jax_rel_l2_mean=float(np.mean([r["jax_rel_l2"] for r in rows])),
                       port_rel_l2_mean=float(np.mean([r["port_rel_l2"] for r in rows])))
        if "topk_sets" in rows[0]:
            summary.update(topk_sets=sum(r["topk_sets"] for r in rows),
                           jax_flips=sum(r["jax_flips"] for r in rows),
                           port_flips=sum(r["port_flips"] for r in rows))
        print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
