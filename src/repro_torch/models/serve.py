"""Serving path of the port: prefill (cache build) and decode (one token)
for the kinds ``attn``, ``attn_local``, ``mla``, ``mlp`` and ``moe``.

Counterpart of ``src/repro/models/serve.py``.  Where the JAX version is
pure and returns updated caches, the port writes each group's cache slice in
place: ``cache`` leaves are views into the stacked ``(p, m, ...)`` cache
buffers (``core/infer_executor.py`` hands them out), and the slice
assignments below write through those views.  ``attn_local`` keeps a ring
of ``min(S, window)`` slots: position P lives in slot ``P % Sc``, after a
prefill as after a decode step (the JAX prefill of a prompt longer than the
ring stores its tail from slot 0 instead, which its decode then misreads
unless the prompt length is a multiple of the ring).  ``mla`` caches the
latent ``c`` and the roped shared key ``kr``, ``kv_lora_rank +
qk_rope_head_dim`` numbers a token, and decodes in the absorbed form, as
the JAX ``decode_block`` does: the query is taken into the latent space
through ``wuk`` and the context out of it through ``wuv``, so no per-head
key or value is ever built from the cache.  ``mlp`` and ``moe``
keep no cache; ``moe`` routes the step's tokens alone, so a decode step's
capacity is that of its b tokens (at least 4 slots an expert) and drops
nothing that a prefill of the same tokens might drop.  ``encdec`` caches
the decoder self-attention's k/v at the decoder's positions (from 0) and
the encoder stream's output ``enc`` (b, s_enc, d) of its prefill; a
decode step is the decoder layer alone, causal self-attention over the
cache and cross-attention over ``enc``, whose k/v it recomputes every step
and which it does not gate by ``dec_on``, as the JAX ``decode_block``.  The
vlm and encdec fronts run in prefill only: a decode step embeds its token
alone.  The recurrent kinds carry O(1) fp32 state and decode in the JAX
step form: ``slstm`` its ``(c, n, m)`` (b, d), ``mlstm`` its matrix memory
``C`` (b, nh, dh, dh), ``rglru`` its ``h`` (b, lru_width).  Where the JAX
prefill runs ``decode_block`` once per prompt position to reach the final
state, the port keeps what its one forward computed: the sLSTM kernel's
last state, the scan's last h, and for ``mlstm`` the decode recurrence's
``C`` in one weighted pass over the prompt (see ``_mlstm_state``).
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from ..core.infer_executor import InferProgram
from ..kernels.ref import slstm_step
from .lm import ArchConfig, RunSpec, _embed_lookup, front_len, group_layout, layer_cfg, make_src
from .modules import (
    ShardCtx,
    _check_kind,
    _head_dim,
    _match_kv_heads,
    _softcap,
    _window,
    apply_mlp,
    apply_moe,
    _mla_dims,
    attn_forward,
    cross_attend,
    encdec_forward,
    mla_forward,
    mlstm_forward,
    rglru_forward,
    rglru_gates,
    rglru_step,
    slstm_forward,
    pad_to_multiple,
    rmsnorm,
    rope,
)

__all__ = [
    "cache_spec",
    "decode_block",
    "prefill_block",
    "make_serve_chunk",
    "build_serve_program",
]


# --------------------------------------------------------------------- #
# per-kind cache init (batch b, max context S)
# --------------------------------------------------------------------- #
def cache_spec(kind: str, cfg: Dict, ctx: ShardCtx, b: int, S: int, dtype, *,
               device, lead=()) -> Dict[str, torch.Tensor]:
    """Zero cache of one layer, shaped ``lead + (b, Sc, hk, dh)`` for attn
    (Sc = S) and attn_local (Sc = min(S, window)); mla keeps ``c`` ``lead +
    (b, S, kv_lora_rank)`` and ``kr`` ``lead + (b, S, qk_rope_head_dim)``;
    encdec the decoder's ``k`` and ``v`` as attn and ``enc`` ``lead + (b,
    s_enc, d)``; the recurrent kinds their fp32 state (``m`` at -1e30), as
    the JAX ``cache_spec``."""
    _check_kind(kind)
    if kind == "encdec":
        shape = tuple(lead) + (b, S, cfg["n_kv_heads"], _head_dim(cfg))
        return {
            "k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "enc": torch.zeros(tuple(lead) + (b, cfg["s_enc"], cfg["d_model"]), dtype=dtype,
                               device=device),
        }
    if kind == "mla":
        _, _, d_kv, d_rope = _mla_dims(cfg)
        lead = tuple(lead) + (b, S)
        return {
            "c": torch.zeros(lead + (d_kv,), dtype=dtype, device=device),
            "kr": torch.zeros(lead + (d_rope,), dtype=dtype, device=device),
        }
    lead = tuple(lead)
    if kind == "slstm":
        shape = lead + (b, cfg["d_model"])
        return {
            "c": torch.zeros(shape, dtype=torch.float32, device=device),
            "n": torch.zeros(shape, dtype=torch.float32, device=device),
            "m": torch.full(shape, -1e30, dtype=torch.float32, device=device),
        }
    if kind == "mlstm":
        nh = cfg["n_heads"]
        dh = cfg["d_model"] // nh
        return {"C": torch.zeros(lead + (b, nh, dh, dh), dtype=torch.float32, device=device)}
    if kind == "rglru":
        d_r = cfg.get("lru_width") or cfg["d_model"]
        return {"h": torch.zeros(lead + (b, d_r), dtype=torch.float32, device=device)}
    if kind in ("attn", "attn_local"):
        window = _window(kind, cfg)
        sc = min(S, window) if window else S
        shape = tuple(lead) + (b, sc, cfg["n_kv_heads"], _head_dim(cfg))
        return {
            "k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
        }
    return {}  # mlp, moe


# --------------------------------------------------------------------- #
# decode: one token through one block
# --------------------------------------------------------------------- #
def _cached_attend(q, kc, vc, pos: int, ring: bool, softcap=None):
    """q: (b, 1, hq, d); kc/vc: (b, Sc, hk, d); pos: the current index.
    A ring cache's slot i holds the largest position P <= pos with
    P % Sc == i, which lies in the window (pos - Sc, pos] by construction;
    it is empty while P < 0 (the JAX ``_ring_attend``'s mask)."""
    rep = q.shape[2] // kc.shape[2]
    k = torch.repeat_interleave(kc, rep, dim=2) if rep > 1 else kc
    v = torch.repeat_interleave(vc, rep, dim=2) if rep > 1 else vc
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float()
    logits = logits / math.sqrt(q.shape[-1])
    logits = _softcap(logits, softcap)
    slot = torch.arange(kc.shape[1], device=q.device)
    if ring:
        mask = pos - torch.remainder(pos - slot, kc.shape[1]) >= 0
    else:
        mask = slot <= pos
    logits = torch.where(mask[None, None, None, :], logits, -1e30)
    p = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def decode_block(kind, p, x, cache, pos: int, cfg, ctx: ShardCtx):
    """x: (b, 1, h) -> (y, cache); writes the new k/v in place at ``pos``
    (attn) or its ring slot ``pos % Sc`` (attn_local)."""
    _check_kind(kind)
    if kind == "mlp":
        return apply_mlp(p, x, cfg, ctx), cache
    if kind == "moe":
        return apply_moe(p, x, cfg, ctx), cache
    if kind == "mla":
        return _decode_mla(p, x, cache, pos, cfg), cache
    if kind == "encdec":
        h, _ = decode_block("attn", p["dec_attn"], x, cache, pos, cfg, ctx)
        h = cross_attend(p["xattn"], h, cache["enc"], cfg, ctx)
        return apply_mlp(p["dec_mlp"], h, cfg, ctx), cache
    if kind in _DECODE_RECURRENT:
        return _DECODE_RECURRENT[kind](p, x, cache, cfg), cache
    b = x.shape[0]
    hq, hk = cfg["n_heads"], cfg["n_kv_heads"]
    dh = _head_dim(cfg)
    posv = torch.full((1,), pos, device=x.device)
    xin = rmsnorm(p["ln"], x)
    q = rope((xin @ p["wq"]).reshape(b, 1, hq, dh), posv)
    k = rope((xin @ p["wk"]).reshape(b, 1, hk, dh), posv)
    v = (xin @ p["wv"]).reshape(b, 1, hk, dh)
    ring = _window(kind, cfg) is not None
    slot = pos % cache["k"].shape[1] if ring else pos
    cache["k"][:, slot : slot + 1] = k  # dynamic_update_slice, in place
    cache["v"][:, slot : slot + 1] = v
    kcm, vcm = _match_kv_heads(hq, cache["k"], cache["v"], cfg, ctx)
    o = _cached_attend(q, kcm, vcm, pos, ring, cfg.get("attn_softcap"))
    o = o.reshape(b, 1, hq * dh) @ p["wo"]
    return x + o, cache


def _decode_mla(p, x, cache, pos: int, cfg):
    """The absorbed MLA decode, in the JAX ``decode_block``'s order of
    products (prefill and decode round differently in bf16, and the
    consistency gates compare the same difference in both packages):
    ``q_lat = q_nope . wuk`` as (kv_lora_rank, hq, dh), scores ``q_lat . c
    + q_rope . kr`` summed in x's dtype, a latent context ``probs . c``,
    then ``. wuv`` and ``@ wo``.  Writes c and kr in place at ``pos``."""
    b = x.shape[0]
    hq = cfg["n_heads"]
    dh, _, d_kv, d_rope = _mla_dims(cfg)
    posv = torch.full((1,), pos, device=x.device)
    xin = rmsnorm(p["ln"], x)
    q_all = ((xin @ p["wdq"]) @ p["wuq"]).reshape(b, 1, hq, dh + d_rope)
    q_nope, q_rope = q_all[..., :dh], rope(q_all[..., dh:], posv)
    ckv = xin @ p["wdkv"]
    cache["c"][:, pos : pos + 1] = ckv[..., :d_kv]  # dynamic_update_slice, in place
    cache["kr"][:, pos : pos + 1] = rope(ckv[..., None, d_kv:], posv)[:, :, 0]
    cc, krc = cache["c"], cache["kr"]
    q_lat = torch.einsum("bqhd,khd->bqhk", q_nope, p["wuk"].reshape(d_kv, hq, dh))
    s_lat = torch.einsum("bqhk,bsk->bhqs", q_lat, cc)
    s_rope = torch.einsum("bqhd,bsd->bhqs", q_rope, krc)
    logits = (s_lat + s_rope).float() / math.sqrt(dh + d_rope)
    kpos = torch.arange(cc.shape[1], device=x.device)
    logits = torch.where(kpos[None, None, None, :] <= pos, logits, -1e30)
    probs = torch.softmax(logits, dim=-1).to(x.dtype)
    ctx_lat = torch.einsum("bhqs,bsk->bqhk", probs, cc)
    o = torch.einsum("bqhk,khd->bqhd", ctx_lat, p["wuv"].reshape(d_kv, hq, dh))
    return x + o.reshape(b, 1, hq * dh) @ p["wo"]


def _decode_slstm(p, x, cache, cfg):
    """One sLSTM step from the fp32 state ``(c, n, m)``, written in place."""
    xin = rmsnorm(p["ln"], x)[:, 0]
    i_t = (xin @ p["si"]).float()
    f_t = (xin @ p["sf"]).float()
    z_t = torch.tanh(xin @ p["sz"]).float()
    o_t = torch.sigmoid(xin @ p["sog"]).float()
    hs, *state = slstm_step(i_t, f_t, z_t, cache["c"], cache["n"], cache["m"])
    for name, t in zip("cnm", state):
        cache[name].copy_(t)
    return x + ((o_t.to(x.dtype) * hs.to(x.dtype)) @ p["so"])[:, None]


def _decode_mlstm(p, x, cache, cfg):
    """One mLSTM step: C = C f + (k i) v^T in fp32, written in place, and
    q C, as the JAX step form."""
    b, _, h = x.shape
    nh = cfg["n_heads"]
    dh = h // nh
    xin = rmsnorm(p["ln"], x)[:, 0]
    q = (xin @ p["mq"]).reshape(b, nh, dh)
    k = (xin @ p["mk"]).reshape(b, nh, dh) / math.sqrt(dh)
    v = (xin @ p["mv"]).reshape(b, nh, dh)
    f_g = torch.sigmoid((xin @ p["mfg"]).float())  # (b, nh)
    i_g = torch.sigmoid((xin @ p["mig"]).float())
    C = cache["C"] * f_g[..., None, None] + torch.einsum(
        "bhd,bhe->bhde", k.float() * i_g[..., None], v.float())
    cache["C"].copy_(C)
    out = torch.einsum("bhd,bhde->bhe", q.float(), C)
    return x + (out.reshape(b, h).to(x.dtype) @ p["mo"])[:, None]


def _decode_rglru(p, x, cache, cfg):
    """One RG-LRU step: h = a h + sqrt(1 - a^2) i u in fp32, written in
    place, and the gated output."""
    xin = rmsnorm(p["ln"], x)[:, 0]
    u = xin @ p["rx"]
    gate_y = torch.nn.functional.gelu(xin @ p["ry"], approximate="tanh")
    r = torch.sigmoid((u @ p["ra"]).float())
    i = torch.sigmoid((u @ p["ri"]).float())
    hs = rglru_step(*rglru_gates(p["lam"], r, i, u), cache["h"])
    cache["h"].copy_(hs)
    return x + ((hs.to(x.dtype) * gate_y) @ p["ro"])[:, None]


_DECODE_RECURRENT = {"slstm": _decode_slstm, "mlstm": _decode_mlstm, "rglru": _decode_rglru}


def _mlstm_state(k, v, f_g, i_g):
    """The decode recurrence's memory after the prompt, C = sum_t (prod_{u >
    t} f_u) (k_t i_t) v_t^T, in fp32, in one weighted pass: k, v (b, nh, s,
    dh) in the model dtype, f_g, i_g (b, nh, s) fp32.  The weights are the
    reversed cumulative products of f (1 for the last position)."""
    rest = torch.flip(torch.cumprod(torch.flip(f_g[..., 1:], dims=(-1,)), dim=-1), dims=(-1,))
    w = torch.cat([rest, torch.ones_like(f_g[..., :1])], dim=-1) * i_g
    return torch.einsum("bhtd,bhte->bhde", k.float() * w[..., None], v.float())


# --------------------------------------------------------------------- #
# prefill: full sequence through one block, emitting the cache
# --------------------------------------------------------------------- #
def prefill_block(kind, p, x, cache, cfg, ctx: ShardCtx, positions):
    """x: (b, s, h) -> (y, cache); writes k/v of positions [0, s) in place,
    position P to slot P (an attn_local ring shorter than s keeps the last
    Sc positions, P in slot ``P % Sc``); mla writes c and the roped kr of
    positions [0, s); encdec the decoder's k/v of its positions [0, s -
    s_enc) and the encoder stream's output; a recurrent kind its state
    after the last position.

    The JAX version runs the train forward and then recomputes rmsnorm and
    the k/v projections (for mla: ``xin @ wdkv`` and the rope) for the cache
    (``src/repro/models/serve.py`` ``prefill_block``); the port keeps what
    the one forward computed.  The numbers are the same, and each attention
    block launches one RMSNorm kernel in prefill instead of two.
    """
    _check_kind(kind)
    if kind == "mlp":
        return apply_mlp(p, x, cfg, ctx), cache
    if kind == "moe":
        return apply_moe(p, x, cfg, ctx), cache
    if kind == "mla":
        s = x.shape[1]
        y, c, kr = mla_forward(p, x, positions, cfg, ctx)
        cache["c"][:, :s] = c
        cache["kr"][:, :s] = kr
        return y, cache
    if kind == "slstm":
        y, (c, n, m) = slstm_forward(p, x, cfg, ctx)
        cache["c"][:] = c
        cache["n"][:] = n
        cache["m"][:] = m
        return y, cache
    if kind == "mlstm":
        y, (k, v, f_g, i_g) = mlstm_forward(p, x, cfg, ctx)
        cache["C"][:] = _mlstm_state(k, v, f_g, i_g)
        return y, cache
    if kind == "rglru":
        y, h_last = rglru_forward(p, x, cfg, ctx)
        cache["h"][:] = h_last
        return y, cache
    if kind == "encdec":
        y, k, v = encdec_forward(p, x, positions, cfg, ctx)
        sd = k.shape[1]
        cache["k"][:, :sd] = k
        cache["v"][:, :sd] = v
        cache["enc"][:] = y[:, :cfg["s_enc"]]
        return y, cache
    s = x.shape[1]
    window = _window(kind, cfg)
    y, k, v = attn_forward(p, x, positions, cfg, ctx, window=window)
    sc = cache["k"].shape[1]
    if sc >= s:
        cache["k"][:, :s] = k
        cache["v"][:, :s] = v
    elif window:
        # positions s - sc .. s - 1 to slots (s - sc + j) % sc = (s + j) % sc
        cache["k"][:] = torch.roll(k[:, s - sc :], s % sc, dims=1)
        cache["v"][:] = torch.roll(v[:, s - sc :], s % sc, dims=1)
    else:
        raise ValueError(f"prefill of {s} tokens into a cache of {sc}")
    return y, cache


# --------------------------------------------------------------------- #
# serve chunk: the per-stage layer group, cache-threaded
# --------------------------------------------------------------------- #
def make_serve_chunk(cfg: ArchConfig, spec: RunSpec, mode: str):
    """Returns (chunk_fn(params, x, side, cache, pos) -> (y, cache),
    cache_init(b, S, *, device, lead=()) -> cache tree) for one chunk."""
    if mode not in ("prefill", "decode"):
        raise ValueError(f"mode {mode!r}: want 'prefill' or 'decode'")
    ctx = ShardCtx(tp_axis=spec.tp_axis, tp_size=spec.tp_size)
    blocks, _ = group_layout(cfg, spec.p, spec.n_chunks)
    lcfg = layer_cfg(cfg, spec.tp_size)

    def cache_init(b: int, S: int, *, device, lead=()):
        return tuple(
            tuple(
                cache_spec(kind, lcfg, ctx, b, S, cfg.torch_dtype(), device=device, lead=lead)
                for kind in kinds
            )
            for kinds in blocks
        )

    def chunk_fn(params, x, side, cache, pos):
        for bi, kinds in enumerate(blocks):
            # a padded block (mask 0) still runs and writes its cache, as in
            # the JAX version; only its output is discarded
            mask = params["mask"][bi].to(x.dtype)
            xb = x
            for ki, kind in enumerate(kinds):
                if mode == "decode":
                    xb, _ = decode_block(
                        kind, params["blocks"][bi][ki], xb, cache[bi][ki], pos, lcfg, ctx
                    )
                else:
                    xb, _ = prefill_block(
                        kind, params["blocks"][bi][ki], xb, cache[bi][ki], lcfg, ctx,
                        side["positions"],
                    )
            x = mask * xb + (1.0 - mask) * x
        return x, cache

    return chunk_fn, cache_init


def build_serve_program(cfg: ArchConfig, spec: RunSpec, placement, mode: str):
    """Returns (InferProgram, cache_init(b, S, *, device, lead=()) for one
    stage's group of blocks)."""
    ctx = ShardCtx(tp_axis=spec.tp_axis, tp_size=spec.tp_size)
    chunk_fn, cache_init = make_serve_chunk(cfg, spec, mode)
    if mode == "decode":  # the step's token alone: the front went in with the prompt
        def src(shared, side_mb):
            return _embed_lookup(shared, side_mb["tokens"], cfg, ctx)
    else:
        src, _ = make_src(cfg, ctx)

    def sink(shared, y, side_mb):
        yl = y[:, -1:].contiguous()  # next-token logits from the last position
        yn = rmsnorm(shared["final_ln"], yl)
        return (yn @ shared["head"])[:, 0]

    s_total = 1 if mode == "decode" else front_len(cfg) + spec.seq_len
    v_l = pad_to_multiple(cfg.vocab, max(1, spec.tp_size)) // max(1, spec.tp_size)
    program = InferProgram(
        chunk_fns=[chunk_fn] * spec.n_chunks,
        src=src,
        sink=sink,
        act_shape=(spec.microbatch, s_total, cfg.d_model),
        act_dtype=cfg.torch_dtype(),
        out_shape=(spec.microbatch, v_l),
        out_dtype=cfg.torch_dtype(),
    )
    return program, cache_init
