"""Layer library of the port: the dense GQA kinds ``attn``, ``attn_local`` and
``mlp``, DeepSeek-V3's latent attention ``mla``, and the ``moe`` kind
(shared + routed top-k experts), at tp=1.

Counterpart of ``src/repro/models/modules.py``: the same functions, names,
parameter layouts (linear weights ``(in, out)``, applied as ``x @ w``) and
numerics, written as plain PyTorch on tensors.  Every RMSNorm goes through
``kernels.ops.rmsnorm`` (the CUDA kernel on the card; differentiable).  The
weight products of a block go through ``core.passes.linear``: plain
``x @ w`` when serving, the deferred linear of the B/W split when a training
block collects its W-context.  Attention stays plain tensor code, as the JAX
package leaves it to XLA: einsum products, the ``-1e30`` mask, softmax in
fp32; ``attn_local`` adds the sliding window (a key is seen by the queries
less than ``window`` positions after it).  ``mla`` projects q through a
low-rank latent and k/v from one shared latent ``c`` plus a single rope key
broadcast to every head (qk width ``head_dim + qk_rope_head_dim``, v width
``head_dim``); its six products all go through ``linear``.  ``moe`` routes
each token to its top-k experts with a per-expert capacity; the router
product goes through ``linear`` (fp32), the expert products through
``core.passes.expert_linear`` and the shared experts through ``linear``.  ``encdec`` is Whisper's
joint block over the concatenated (encoder, decoder) stream: a non-causal
encoder layer, then a causal decoder layer with cross-attention on the
encoder's output (its k/v from the encoder stream unnormed, no rope), each
gated by its ``enc_on`` / ``dec_on`` scalar; its 18 products all go
through ``linear``.  The recurrent kinds: ``slstm`` (xLSTM's scalar
memory with exponential gating; its time loop is ``kernels.ops.slstm_scan``,
a CUDA kernel on the card), ``mlstm`` (xLSTM's matrix memory in the
chunkwise-parallel form) and ``rglru`` (RecurrentGemma's gated linear
recurrence, as a log-depth scan by default); all their weight products go
through ``linear``, and ``rglru``'s fp32 gate scale ``lam`` is a cheap leaf
whose gradient B finishes, as it does the norm gains'.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
from typing import Callable, Dict, Optional, Tuple

import torch

from ..core.passes import expert_linear, linear
from ..kernels import ops

__all__ = [
    "ShardCtx",
    "init_layer",
    "apply_layer",
    "apply_block",
    "vocab_parallel_ce",
    "LAYER_KINDS",
    "PORTED_KINDS",
    "UNPORTED_KINDS",
    "rmsnorm",
    "rope",
    "attention",
    "cross_attend",
    "encdec_forward",
    "slstm_forward",
    "mlstm_forward",
    "rglru_forward",
    "rglru_gates",
    "rglru_step",
    "pad_to_multiple",
    "leaves_into",
]

# kinds of the JAX layer library that this port does not carry yet (none)
UNPORTED_KINDS: Tuple[str, ...] = ()
PORTED_KINDS = ("attn", "attn_local", "mla", "mlp", "moe", "slstm", "mlstm", "rglru", "encdec")


@dataclasses.dataclass(frozen=True)
class ShardCtx:
    """Tensor-parallel context; the port runs at tp=1 only so far."""

    tp_axis: Optional[str] = None
    tp_size: int = 1

    def __post_init__(self):
        if self.tp_axis is not None or self.tp_size != 1:
            raise NotImplementedError(
                f"tensor parallelism (tp_axis={self.tp_axis!r}, tp_size={self.tp_size}) "
                "is not ported to repro_torch yet"
            )

    def index(self) -> int:
        return 0


def pad_to_multiple(n: int, k: int) -> int:
    return ((n + k - 1) // k) * k


def _check_kind(kind: str) -> None:
    if kind not in PORTED_KINDS:
        raise NotImplementedError(
            f"layer kind {kind!r} is not ported to repro_torch yet (ported: {PORTED_KINDS})"
        )


def _head_dim(cfg) -> int:
    return cfg.get("head_dim") or cfg["d_model"] // cfg["n_heads"]


def _window(kind: str, cfg) -> Optional[int]:
    """The sliding window of an attention kind (None: global)."""
    return cfg.get("window", 4096) if kind == "attn_local" else None


# --------------------------------------------------------------------- #
# primitives
# --------------------------------------------------------------------- #
# where an initialiser's leaves live: None allocates each afresh on the
# generator's device; a callable ``alloc(shape, dtype)`` hands out the
# tensor to fill instead (``models/lm.py`` fills stage-stacked leaves in
# place; a "meta" tensor is left unfilled and draws nothing)
_LEAF_ALLOC: contextvars.ContextVar[Optional[Callable]] = contextvars.ContextVar(
    "repro_torch_leaf_alloc", default=None)
# a leaf of more elements is drawn in slices of this many (1 GiB of fp32):
# the fp32 draw of a whole (256, 7168, 2048) expert stack would take 15 GB.
# No config ported before deepseek_v3_671b has a block leaf this large
# (deepseek_67b's widest is 180 M), so their weights keep the bits of one
# whole draw
DRAW_SLICE = 1 << 28


@contextlib.contextmanager
def leaves_into(alloc: Callable):
    """While active, every leaf the initialisers make is ``alloc(shape,
    dtype)``, in draw order, filled in place."""
    token = _LEAF_ALLOC.set(alloc)
    try:
        yield
    finally:
        _LEAF_ALLOC.reset(token)


def _leaf(gen: torch.Generator, shape, dtype) -> torch.Tensor:
    alloc = _LEAF_ALLOC.get()
    if alloc is None:
        return torch.empty(shape, dtype=dtype, device=gen.device)
    out = alloc(tuple(shape), dtype)
    if tuple(out.shape) != tuple(shape) or out.dtype != dtype:
        raise ValueError(f"leaf allocator gave {tuple(out.shape)} {out.dtype} for {shape} {dtype}")
    return out


def _zeros(gen: torch.Generator, shape, dtype) -> torch.Tensor:
    out = _leaf(gen, shape, dtype)
    return out if out.is_meta else out.zero_()


def _full(gen: torch.Generator, shape, value, dtype) -> torch.Tensor:
    out = _leaf(gen, shape, dtype)
    return out if out.is_meta else out.fill_(value)


def _ones(gen: torch.Generator, shape, dtype) -> torch.Tensor:
    return _full(gen, shape, 1, dtype)


def _normal(gen: torch.Generator, shape, scale, dtype) -> torch.Tensor:
    """``N(0, 1) * scale`` drawn in fp32, cast to ``dtype``; a leaf of more
    than :data:`DRAW_SLICE` elements is drawn slice by slice."""
    out = _leaf(gen, shape, dtype)
    if out.is_meta:
        return out
    flat = out.view(-1)
    for i in range(0, flat.numel(), DRAW_SLICE):
        k = min(DRAW_SLICE, flat.numel() - i)
        draw = torch.randn(shape if k == flat.numel() else (k,), generator=gen,
                           device=gen.device, dtype=torch.float32)
        flat[i:i + k].copy_((draw * scale).reshape(-1))
    return out


def rmsnorm(g: torch.Tensor, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Argument order as in the JAX package; x must be contiguous."""
    return ops.rmsnorm(x, g, eps)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0) -> torch.Tensor:
    """x: (b, s, h, d); positions: (s,)."""
    d = x.shape[-1]
    half = d // 2
    freqs = torch.exp(
        -math.log(theta)
        * torch.arange(0, half, dtype=torch.float32, device=x.device)
        / half
    )
    ang = (positions[None, :, None].float() * freqs)[:, :, None, :]  # (1, s, 1, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def _softcap(x, cap):
    if cap is None or cap <= 0:
        return x
    return cap * torch.tanh(x / cap)


# --------------------------------------------------------------------- #
# attention (dense for short sequences, a loop over query blocks beyond)
# --------------------------------------------------------------------- #
def _attend_dense(q, k, v, softcap, window=None, q_offset=0, causal=True):
    """Causal (unless ``causal`` is False), within ``window`` when given.
    q: (b, sq, hq, d); k/v: (b, sk, hq, d) head-matched -> (b, sq, hq, d);
    sq and sk may differ (cross-attention)."""
    sq, sk = q.shape[1], k.shape[1]
    d = q.shape[-1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() / math.sqrt(d)
    logits = _softcap(logits, softcap)
    qpos = torch.arange(sq, device=q.device) + q_offset
    kpos = torch.arange(sk, device=q.device)
    mask = None
    if causal:
        mask = kpos[None, :] <= qpos[:, None]
    if window is not None and window > 0:
        near = kpos[None, :] > qpos[:, None] - window
        mask = near if mask is None else mask & near
    if mask is not None:
        logits = torch.where(mask[None, None], logits, -1e30)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _attend_chunked(q, k, v, softcap, window=None, block=1024, causal=True):
    """Query blocks one at a time, so the scores stay (block, sk) per head.
    Serving keeps no residuals, so the JAX version's remat has no part there;
    a training step at s > 2 * block keeps every block's scores for B."""
    s = q.shape[1]
    outs = [
        _attend_dense(q[:, i : i + block], k, v, softcap, window, q_offset=i, causal=causal)
        for i in range(0, s, block)
    ]
    return torch.cat(outs, dim=1)


def _match_kv_heads(q_heads_local, k, v, cfg, ctx: ShardCtx):
    """Repeat kv heads so k/v carry one head per local q head (tp=1)."""
    rep = q_heads_local // k.shape[2]
    if rep > 1:
        k = torch.repeat_interleave(k, rep, dim=2)
        v = torch.repeat_interleave(v, rep, dim=2)
    return k, v


def attention(q, k, v, *, causal=True, window=None, softcap=None, block=1024):
    """Attention, causal unless ``causal`` is False (within ``window`` when
    given): dense up to 2 * block queries, query blocks beyond."""
    if q.shape[1] <= 2 * block:
        return _attend_dense(q, k, v, softcap, window, causal=causal)
    return _attend_chunked(q, k, v, softcap, window, block, causal=causal)


# --------------------------------------------------------------------- #
# dense attention + MLP
# --------------------------------------------------------------------- #
def init_attn(gen: torch.Generator, cfg, dtype) -> Dict[str, torch.Tensor]:
    h, hq, hk = cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"]
    dh = _head_dim(cfg)
    sc = 1.0 / math.sqrt(h)
    so = sc / math.sqrt(2 * cfg["n_layers"])
    return {
        "ln": _zeros(gen, (h,), dtype),
        "wq": _normal(gen, (h, hq * dh), sc, dtype),
        "wk": _normal(gen, (h, hk * dh), sc, dtype),
        "wv": _normal(gen, (h, hk * dh), sc, dtype),
        "wo": _normal(gen, (hq * dh, h), so, dtype),
    }


def attn_forward(p, x, positions, cfg, ctx: ShardCtx, *, window=None, causal=True):
    """``apply_attn`` that also returns the roped k and the v it attended
    with, before the kv-head repeat: (y, k, v), k/v (b, s, hk, dh).
    ``causal=False`` is the encoder's self-attention."""
    b, s, _ = x.shape
    hq, hk = cfg["n_heads"], cfg["n_kv_heads"]
    dh = _head_dim(cfg)
    xin = rmsnorm(p["ln"], x)
    q = linear(xin, p["wq"]).reshape(b, s, hq, dh)
    k = linear(xin, p["wk"]).reshape(b, s, hk, dh)
    v = linear(xin, p["wv"]).reshape(b, s, hk, dh)
    q, k = rope(q, positions), rope(k, positions)
    km, vm = _match_kv_heads(hq, k, v, cfg, ctx)
    o = attention(q, km, vm, causal=causal, window=window, softcap=cfg.get("attn_softcap"))
    o = linear(o.reshape(b, s, hq * dh), p["wo"])
    return x + o, k, v


def apply_attn(p, x, positions, cfg, ctx: ShardCtx, *, window=None):
    return attn_forward(p, x, positions, cfg, ctx, window=window)[0]


def init_mlp(gen: torch.Generator, cfg, dtype) -> Dict[str, torch.Tensor]:
    h, f = cfg["d_model"], cfg["d_ff"]
    sc = 1.0 / math.sqrt(h)
    return {
        "ln": _zeros(gen, (h,), dtype),
        "wu": _normal(gen, (h, f), sc, dtype),
        "wg": _normal(gen, (h, f), sc, dtype),
        "wd": _normal(gen, (f, h), sc / math.sqrt(2 * cfg["n_layers"]), dtype),
    }


def apply_mlp(p, x, cfg, ctx: ShardCtx):
    xin = rmsnorm(p["ln"], x)
    up = linear(xin, p["wu"])
    gate = torch.nn.functional.silu(linear(xin, p["wg"]))
    return x + linear(up * gate, p["wd"])


# --------------------------------------------------------------------- #
# MLA (DeepSeek-V3): latent-compressed attention
# --------------------------------------------------------------------- #
def _mla_dims(cfg) -> Tuple[int, int, int, int]:
    """(head_dim, q_lora_rank, kv_lora_rank, qk_rope_head_dim), with the
    JAX package's defaults."""
    return (_head_dim(cfg), cfg.get("q_lora_rank") or 1536, cfg.get("kv_lora_rank") or 512,
            cfg.get("qk_rope_head_dim") or 64)


def init_mla(gen: torch.Generator, cfg, dtype) -> Dict[str, torch.Tensor]:
    h, hq = cfg["d_model"], cfg["n_heads"]
    dh, d_q, d_kv, d_rope = _mla_dims(cfg)
    sc = 1.0 / math.sqrt(h)
    return {
        "ln": _zeros(gen, (h,), dtype),
        "wdq": _normal(gen, (h, d_q), sc, dtype),
        "wuq": _normal(gen, (d_q, hq * (dh + d_rope)), 1 / math.sqrt(d_q), dtype),
        "wdkv": _normal(gen, (h, d_kv + d_rope), sc, dtype),
        "wuk": _normal(gen, (d_kv, hq * dh), 1 / math.sqrt(d_kv), dtype),
        "wuv": _normal(gen, (d_kv, hq * dh), 1 / math.sqrt(d_kv), dtype),
        "wo": _normal(gen, (hq * dh, h), sc / math.sqrt(2 * cfg["n_layers"]), dtype),
    }


def mla_forward(p, x, positions, cfg, ctx: ShardCtx):
    """``apply_mla`` that also returns what the serve cache keeps: the
    latent c (b, s, kv_lora_rank) and the roped shared key (b, s,
    qk_rope_head_dim).  q is (head_dim + rope) wide per head, v head_dim
    wide, so the scale is 1/sqrt(head_dim + rope), as the JAX attention
    takes it from q's width."""
    b, s, _ = x.shape
    hq = cfg["n_heads"]
    dh, _, d_kv, d_rope = _mla_dims(cfg)
    xin = rmsnorm(p["ln"], x)
    q_all = linear(linear(xin, p["wdq"]), p["wuq"]).reshape(b, s, hq, dh + d_rope)
    q_nope, q_rope = q_all[..., :dh], q_all[..., dh:]
    ckv = linear(xin, p["wdkv"])
    c, k_rope = ckv[..., :d_kv], ckv[..., d_kv:]
    k_nope = linear(c, p["wuk"]).reshape(b, s, hq, dh)
    v = linear(c, p["wuv"]).reshape(b, s, hq, dh)
    q_rope = rope(q_rope, positions)
    k_rope = rope(k_rope[:, :, None, :], positions)  # one key, shared by the heads
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope.expand(b, s, hq, d_rope)], dim=-1)
    o = attention(q, k, v)
    o = linear(o.reshape(b, s, hq * dh), p["wo"])
    return x + o, c, k_rope[:, :, 0]


def apply_mla(p, x, positions, cfg, ctx: ShardCtx):
    return mla_forward(p, x, positions, cfg, ctx)[0]


# --------------------------------------------------------------------- #
# MoE: shared + routed top-k experts (tp=1: every expert is local)
# --------------------------------------------------------------------- #
def _e_pad(cfg) -> int:
    return pad_to_multiple(cfg["n_experts"], cfg.get("tp_size", 1))


def init_moe(gen: torch.Generator, cfg, dtype) -> Dict[str, torch.Tensor]:
    """The router is float32 whatever ``dtype`` is, as in the JAX package."""
    h, f = cfg["d_model"], cfg["moe_d_ff"]
    e_p = _e_pad(cfg)
    n_sh = cfg.get("n_shared_experts", 0)
    sc = 1.0 / math.sqrt(h)
    so = sc / math.sqrt(2 * cfg["n_layers"])
    params = {
        "ln": _zeros(gen, (h,), dtype),
        "router": _normal(gen, (h, cfg["n_experts"]), sc, torch.float32),
        "wu": _normal(gen, (e_p, h, f), sc, dtype),
        "wg": _normal(gen, (e_p, h, f), sc, dtype),
        "wd": _normal(gen, (e_p, f, h), so, dtype),
    }
    if n_sh:
        f_sh = f * n_sh
        params.update({
            "swu": _normal(gen, (h, f_sh), sc, dtype),
            "swg": _normal(gen, (h, f_sh), sc, dtype),
            "swd": _normal(gen, (f_sh, h), so, dtype),
        })
    return params


def moe_capacity(cfg, n_tokens: int) -> int:
    """Slots per expert for ``n_tokens`` tokens, from shapes on the host:
    ``cfg["capacity"]`` if set, else ceil(n k / E * capacity_factor)
    clamped to [4, n] (at least 4)."""
    cap = cfg.get("capacity", None)
    if cap is None:
        cap = int(math.ceil(n_tokens * cfg["topk"] / cfg["n_experts"]
                            * cfg.get("capacity_factor", 1.25)))
        cap = max(4, min(cap, n_tokens))
    return cap


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """int64 one-hot over n classes, all zeros for an index outside [0, n)
    (``jax.nn.one_hot``'s rule); unlike ``F.one_hot`` it reads no bound
    back to the host."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).long()


def _moe_route(p, tok, cfg):
    """Top-k routing with per-expert slot positions.  Returns (top_g, top_i,
    pos_nk, onehot): top_g (N, k) fp32 gates renormalised over the k
    choices, top_i (N, k) expert indices in descending gate order (ties to
    the lower index, as ``lax.top_k``), pos_nk (N, k) int64, the number of
    earlier selections of the same expert in the flattened (n, k) order,
    and onehot (N, k, E_p) fp32.  No host read: the shapes alone size
    every tensor."""
    logits = linear(tok.float(), p["router"])  # (N, E) real experts, fp32
    gates = torch.softmax(logits, dim=-1)
    order = torch.sort(gates.detach(), dim=-1, descending=True, stable=True).indices
    top_i = order[:, :cfg["topk"]].contiguous()
    pos_nk, onehot = _slot_positions(top_i, _e_pad(cfg))
    return _chosen_gates(gates, top_i), top_i, pos_nk, onehot


def _chosen_gates(gates, top_i):
    """The gates of the chosen experts, renormalised over the k choices."""
    top_g = torch.gather(gates, -1, top_i)
    return top_g / (torch.sum(top_g, dim=-1, keepdim=True) + 1e-9)


def _slot_positions(top_i, e_p: int):
    """(pos_nk int64, onehot (N, k, E_p) fp32) of the choices top_i (N, k):
    each selection's count of earlier selections of its expert in the
    flattened (n, k) order."""
    n, k_top = top_i.shape
    onehot = _one_hot(top_i, e_p)
    flat = onehot.reshape(n * k_top, e_p)
    # inclusive count of each expert's selections so far, read at the
    # selection's own expert, minus itself
    pos_nk = torch.gather(torch.cumsum(flat, dim=0), 1, top_i.reshape(-1, 1)) - 1
    return pos_nk.reshape(n, k_top), onehot.float()


def _dispatch_einsum(tok, top_g, top_i, pos_nk, onehot, cap, e_l, ei, dtype):
    """The dense (Mesh-TF) dispatch: one-hot products, O(N k cap) and
    O(N E cap h).  The oracle the scatter dispatch is held to."""
    keep = pos_nk < cap
    pos_oh = _one_hot(pos_nk, cap).float()  # (N, k, cap); a dropped selection is all zeros
    sel = onehot * keep[..., None].float()  # (N, k, E_p)
    sel_l = sel[:, :, ei:ei + e_l]
    disp_l = torch.einsum("nke,nkc->nec", sel_l, pos_oh)
    comb_l = torch.einsum("nke,nkc->nec", sel_l * top_g[..., None], pos_oh)
    xe = torch.einsum("nec,nh->ech", disp_l, tok.float()).to(dtype)
    return xe, comb_l


class _Dispatch(torch.autograd.Function):
    """xe = tok_pad[tok_of_slot]: each expert slot's token row (a zero row
    where the slot is empty).  The backward gathers each selection's slot
    by ``flat`` and sums over k in order, in fp32: no scatter-add, so no
    atomics and the same bits in every run."""

    @staticmethod
    def forward(ctx, tok, tok_of_slot, flat):
        ctx.save_for_backward(flat)
        pad = torch.cat([tok, tok.new_zeros((1, tok.shape[1]))], dim=0)
        return pad[tok_of_slot]

    @staticmethod
    def backward(ctx, dxe):
        (flat,) = ctx.saved_tensors
        pad = torch.cat([dxe, dxe.new_zeros((1, dxe.shape[1]))], dim=0)
        return pad[flat].float().sum(dim=1).to(dxe.dtype), None, None


class _Combine(torch.autograd.Function):
    """picked = out_pad[flat]: each (token, choice) selection's expert
    output (zeros for a dropped one).  Slots are unique but for the
    sentinel, so the backward gathers by the slot's selection instead of
    scatter-adding."""

    @staticmethod
    def forward(ctx, out_flat, flat, sel_of_slot):
        ctx.save_for_backward(sel_of_slot)
        pad = torch.cat([out_flat, out_flat.new_zeros((1, out_flat.shape[1]))], dim=0)
        return pad[flat]

    @staticmethod
    def backward(ctx, dpicked):
        (sel_of_slot,) = ctx.saved_tensors
        h = dpicked.shape[-1]
        pad = torch.cat([dpicked.reshape(-1, h), dpicked.new_zeros((1, h))], dim=0)
        return pad[sel_of_slot], None, None


def _expert_ffn(p, xe):
    up = expert_linear(xe, p["wu"])
    gate = torch.nn.functional.silu(expert_linear(xe, p["wg"]))
    return expert_linear(up * gate, p["wd"])


def apply_moe(p, x, cfg, ctx: ShardCtx):
    """Shared + routed top-k experts, capacity-bounded.

    ``moe_dispatch="scatter"`` (the default) moves tokens by slot index:
    each kept selection (n, j) owns slot ``top_i * cap + pos`` of the
    (E_p * cap) expert rows, and a selection past its expert's capacity is
    dropped (its gate counts for nothing).  ``"einsum"`` is the dense
    one-hot oracle.  The router's gradient flows through the combine
    weights under both."""
    b, s, h = x.shape
    e_p = _e_pad(cfg)
    e_l, ei = e_p, ctx.index() * e_p
    n = b * s
    cap = moe_capacity(cfg, n)
    xin = rmsnorm(p["ln"], x)
    tok = xin.reshape(n, h)
    top_g, top_i, pos_nk, onehot = _moe_route(p, tok, cfg)

    if cfg.get("moe_dispatch", "scatter") == "einsum":
        xe, comb_l = _dispatch_einsum(tok, top_g, top_i, pos_nk, onehot, cap, e_l, ei, x.dtype)
        out_e = _expert_ffn(p, xe)
        y = torch.einsum("nec,ech->nh", comb_l, out_e.float())
    else:
        k_top = top_i.shape[1]
        loc_e = top_i - ei
        keep = (pos_nk < cap) & (loc_e >= 0) & (loc_e < e_l)
        flat = torch.where(keep, loc_e * cap + pos_nk, torch.full_like(pos_nk, e_l * cap))
        # slot -> selection n * k + j (the sentinel selection n * k: empty)
        sel_of_slot = torch.full((e_l * cap + 1,), n * k_top, dtype=torch.long, device=x.device)
        sel_of_slot.scatter_(0, flat.reshape(-1), torch.arange(n * k_top, device=x.device))
        sel_of_slot = sel_of_slot[:-1]  # the sentinel slot's entry is whichever wrote last
        xe = _Dispatch.apply(tok, sel_of_slot // k_top, flat).reshape(e_l, cap, h)
        out_e = _expert_ffn(p, xe)
        picked = _Combine.apply(out_e.reshape(e_l * cap, h), flat, sel_of_slot)
        w = top_g * keep.float()
        y = torch.einsum("nkh,nk->nh", picked.float(), w)

    y = y.to(x.dtype)
    if "swu" in p:
        up = linear(tok, p["swu"])
        gate = torch.nn.functional.silu(linear(tok, p["swg"]))
        y = y + linear(up * gate, p["swd"])
    return x + y.reshape(b, s, h)


# --------------------------------------------------------------------- #
# xLSTM blocks (recurrent state is elementwise per channel or head)
# --------------------------------------------------------------------- #
def init_slstm(gen: torch.Generator, cfg, dtype) -> Dict[str, torch.Tensor]:
    h = cfg["d_model"]
    sc = 1.0 / math.sqrt(h)
    return {
        "ln": _zeros(gen, (h,), dtype),
        "si": _normal(gen, (h, h), sc, dtype),
        "sf": _normal(gen, (h, h), sc, dtype),
        "sz": _normal(gen, (h, h), sc, dtype),
        "sog": _normal(gen, (h, h), sc, dtype),
        "so": _normal(gen, (h, h), sc / math.sqrt(2 * cfg["n_layers"]), dtype),
    }


def slstm_forward(p, x, cfg, ctx: ShardCtx):
    """``apply_slstm`` that also returns the state after the last step,
    ``(c, n, m)`` fp32 (b, h), which a prefill keeps.  The gates' products
    in x's dtype, cast to fp32 (``z`` after its tanh, ``o`` after its
    sigmoid), the time loop in fp32 through ``kernels.ops.slstm_scan``, h
    cast back to x's dtype, as the JAX step."""
    xin = rmsnorm(p["ln"], x)
    i_pre = linear(xin, p["si"]).float()
    f_pre = linear(xin, p["sf"]).float()
    z = torch.tanh(linear(xin, p["sz"])).float()
    o = torch.sigmoid(linear(xin, p["sog"])).float()
    hs, state = ops.slstm_scan(i_pre, f_pre, z)
    return x + linear(o.to(x.dtype) * hs.to(x.dtype), p["so"]), state


def apply_slstm(p, x, cfg, ctx: ShardCtx):
    """sLSTM: scalar-memory recurrence with exponential gating (stabilized)."""
    return slstm_forward(p, x, cfg, ctx)[0]


def init_mlstm(gen: torch.Generator, cfg, dtype) -> Dict[str, torch.Tensor]:
    h, nh = cfg["d_model"], cfg["n_heads"]
    sc = 1.0 / math.sqrt(h)
    return {
        "ln": _zeros(gen, (h,), dtype),
        "mq": _normal(gen, (h, h), sc, dtype),
        "mk": _normal(gen, (h, h), sc, dtype),
        "mv": _normal(gen, (h, h), sc, dtype),
        "mfg": _normal(gen, (h, nh), sc, dtype),
        "mig": _normal(gen, (h, nh), sc, dtype),
        "mo": _normal(gen, (h, h), sc / math.sqrt(2 * cfg["n_layers"]), dtype),
    }


def _rounded(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """fp32 ``t`` rounded to ``dtype`` and back: an einsum operand that the
    JAX code casts to the model dtype."""
    return t.to(dtype).float()


def mlstm_forward(p, x, cfg, ctx: ShardCtx, chunk: int = 128):
    """``apply_mlstm`` that also returns what a prefill needs to build the
    decode state: k (scaled by 1/sqrt(dh)) and v, (b, nh, s, dh) in x's
    dtype, and the gates f and i, (b, nh, s) fp32.

    The chunkwise-parallel form of the JAX package, step for step: chunks of
    ``chunk`` positions (the last padded with f = 1, i = 0), within a chunk
    a causal decay-weighted attention from ``log(f + 1e-6)``, across chunks
    the memory ``C`` (b, nh, dh, dh) carried in x's dtype; every chunk's
    terms are computed at once, the carry of C alone is a loop.  Each einsum
    takes its operands in the JAX dtypes (q, k, v and C in x's dtype, the
    masked scores and the decay-weighted q and k rounded to it where the
    JAX code casts them) and sums in fp32; the sums that XLA fuses with
    them, C's decay plus its update and the intra- plus the inter-chunk
    output, are taken in fp32 and rounded to x's dtype once, as XLA's
    excess precision takes them on the JAX side (in bf16 a rounding after
    every product and sum put the port's decode-vs-prefill gap 1.7x the
    JAX package's at 24 layers; ``tools/serve_consistency.py``).  In
    float32 these are the JAX numbers, and so is the gradient wherever the
    JAX one is finite: the JAX decay overflows in its masked half once a
    chunk's forget gates multiply below ~1e-38 (its gradient is then NaN;
    a full-width chunk of 128 gets there), the port's exponent is masked.  The JAX package wraps each chunk's
    step in ``jax.checkpoint``; the port keeps its residuals instead, which
    changes no number, only what a training step holds between F and B."""
    b, s, h = x.shape
    nh = cfg["n_heads"]
    dh = h // nh
    xin = rmsnorm(p["ln"], x)
    q = linear(xin, p["mq"]).reshape(b, s, nh, dh).transpose(1, 2)
    k = linear(xin, p["mk"]).reshape(b, s, nh, dh).transpose(1, 2) / math.sqrt(dh)
    v = linear(xin, p["mv"]).reshape(b, s, nh, dh).transpose(1, 2)
    f_g = torch.sigmoid(linear(xin, p["mfg"]).float()).transpose(1, 2)
    i_g = torch.sigmoid(linear(xin, p["mig"]).float()).transpose(1, 2)

    nc = -(-s // chunk)
    pad = nc * chunk - s
    qp, kp, vp, fp, ip = q, k, v, f_g, i_g
    if pad:
        qp, kp, vp = (torch.nn.functional.pad(t, (0, 0, 0, pad)) for t in (q, k, v))
        fp = torch.nn.functional.pad(f_g, (0, pad), value=1.0)
        ip = torch.nn.functional.pad(i_g, (0, pad))
    # every chunk at once, (b, nh, nc, chunk, ...); only C's carry is a loop
    qc, kc, vc = (t.reshape(b, nh, nc, chunk, dh).float() for t in (qp, kp, vp))
    fc, ic = fp.reshape(b, nh, nc, chunk), ip.reshape(b, nh, nc, chunk)
    cum = torch.cumsum(torch.log(fc + 1e-6), dim=-1)
    total = cum[..., -1:]
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=x.device))
    # the masked half's exponent is set to -inf before the exp, not its
    # value to 0 after (as the JAX code does): past a few dozen positions
    # a chunk's cum(log f) spans more than fp32's exp range, so the
    # masked half overflows to inf and 0 * inf makes the gradient NaN
    decay = torch.exp(torch.where(causal, cum[..., :, None] - cum[..., None, :],
                                  float("-inf")))
    att = torch.einsum("bhnqd,bhnkd->bhnqk", qc, kc) * decay * ic[..., None, :]
    intra = torch.einsum("bhnqk,bhnkd->bhnqd", _rounded(att, x.dtype), vc)
    qdec = _rounded(qc * torch.exp(cum)[..., None], x.dtype)
    C = [torch.zeros((b, nh, dh, dh), dtype=x.dtype, device=x.device)]
    if nc > 1:  # what each chunk but the last adds to the memory, and keeps of it
        cum_, total_, ic_ = cum[:, :, :-1], total[:, :, :-1], ic[:, :, :-1]
        kdec = _rounded(kc[:, :, :-1] * (torch.exp(total_ - cum_) * ic_)[..., None], x.dtype)
        update = torch.einsum("bhnkd,bhnke->bhnde", kdec, vc[:, :, :-1])
        keep = _rounded(torch.exp(total_)[..., None], x.dtype)
        for j in range(nc - 1):  # the memory before chunk j + 1, carried in x's dtype
            C.append((C[-1].float() * keep[:, :, j] + update[:, :, j]).to(x.dtype))
    inter = torch.einsum("bhnqd,bhnde->bhnqe", qdec, torch.stack(C, dim=2).float())
    out = (intra + inter).to(x.dtype).reshape(b, nh, nc * chunk, dh)[:, :, :s]
    out = out.transpose(1, 2).reshape(b, s, h)
    return x + linear(out, p["mo"]), (k, v, f_g, i_g)


def apply_mlstm(p, x, cfg, ctx: ShardCtx, chunk: int = 128):
    """mLSTM matrix memory in chunkwise-parallel (linear-attention) form."""
    return mlstm_forward(p, x, cfg, ctx, chunk)[0]


# --------------------------------------------------------------------- #
# RG-LRU (RecurrentGemma)
# --------------------------------------------------------------------- #
def init_rglru(gen: torch.Generator, cfg, dtype) -> Dict[str, torch.Tensor]:
    """The gate scale ``lam`` is float32 whatever ``dtype`` is, as in the
    JAX package."""
    h = cfg["d_model"]
    d_r = cfg.get("lru_width") or h
    sc = 1.0 / math.sqrt(h)
    return {
        "ln": _zeros(gen, (h,), dtype),
        "rx": _normal(gen, (h, d_r), sc, dtype),
        "ry": _normal(gen, (h, d_r), sc, dtype),
        "ra": _normal(gen, (d_r, d_r), 1 / math.sqrt(d_r), dtype),
        "ri": _normal(gen, (d_r, d_r), 1 / math.sqrt(d_r), dtype),
        "lam": _full(gen, (d_r,), 2.0, torch.float32),
        "ro": _normal(gen, (d_r, h), sc / math.sqrt(2 * cfg["n_layers"]), dtype),
    }


def linear_scan(a: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The inclusive scan of h_t = a_t h_{t-1} + g_t along dim 1 from h = 0,
    in ceil(log2 s) levels of elementwise ops (the log-depth form of
    ``lax.associative_scan`` with the combine (a1, h1), (a2, h2) -> (a1 a2,
    a2 h1 + h2)): level k combines every position with the one 2^k before
    it.  Differentiable by autograd."""
    s, k = a.shape[1], 1
    h = g
    while k < s:
        h_new = h.clone()
        h_new[:, k:] = a[:, k:] * h[:, :-k] + h[:, k:]
        if 2 * k < s:  # the products of a that a next level reads
            a_new = a.clone()
            a_new[:, k:] = a[:, k:] * a[:, :-k]
            a = a_new
        h, k = h_new, 2 * k
    return h


def rglru_gates(lam, r, i, u):
    """The RG-LRU's decay ``a = exp(-8 softplus(lam) r)`` and gated input
    ``sqrt(max(1 - a^2, 1e-12)) i u``, fp32, from the fp32 gates r and i and
    the input u: for a whole sequence (:func:`rglru_forward`) and for a
    decode step (``models/serve.py``) alike."""
    log_a = -8.0 * torch.nn.functional.softplus(lam) * r
    floor = torch.full((), 1e-12, dtype=torch.float32, device=r.device)
    gated = (torch.sqrt(torch.maximum(1.0 - torch.exp(2.0 * log_a), floor)) * i) * u.float()
    return torch.exp(log_a), gated


def rglru_step(a, gated, h):
    """One step of the RG-LRU recurrence, ``h = a h + gated`` (fp32): the
    sequential form's and a decode step's."""
    return a * h + gated


def rglru_forward(p, x, cfg, ctx: ShardCtx):
    """``apply_rglru`` that also returns the recurrence's last h, fp32 (b,
    d_r), which a prefill keeps.

    ``cfg["rglru_scan"]``: ``"associative"`` (the default) runs the
    recurrence as :func:`linear_scan`, ``"sequential"`` as a loop over time
    (the JAX ``lax.scan`` form).  ``jax.nn.gelu`` is the tanh
    approximation, so the gate is ``gelu(..., approximate="tanh")``."""
    b, s, _ = x.shape
    xin = rmsnorm(p["ln"], x)
    u = linear(xin, p["rx"])
    gate_y = torch.nn.functional.gelu(linear(xin, p["ry"]), approximate="tanh")
    r = torch.sigmoid(linear(u, p["ra"]).float())
    i = torch.sigmoid(linear(u, p["ri"]).float())
    a, gated = rglru_gates(p["lam"], r, i, u)
    if cfg.get("rglru_scan", "associative") == "sequential":
        hc = torch.zeros((b, a.shape[-1]), dtype=torch.float32, device=x.device)
        steps = []
        for t in range(s):
            hc = rglru_step(a[:, t], gated[:, t], hc)
            steps.append(hc)
        hs = torch.stack(steps, dim=1)
    else:
        hs = linear_scan(a, gated)
    return x + linear(hs.to(x.dtype) * gate_y, p["ro"]), hs[:, -1]


def apply_rglru(p, x, cfg, ctx: ShardCtx):
    """Gated linear recurrence: h_t = a_t * h_{t-1} + gated_t."""
    return rglru_forward(p, x, cfg, ctx)[0]


# --------------------------------------------------------------------- #
# encoder/decoder joint block (Whisper; concat-carry)
# --------------------------------------------------------------------- #
def init_encdec(gen: torch.Generator, cfg, dtype) -> Dict[str, torch.Tensor]:
    """The JAX ``init_encdec``'s leaves, drawn in its order; the role
    scalars start at 1."""
    return {
        "enc_attn": init_attn(gen, cfg, dtype),
        "enc_mlp": init_mlp(gen, cfg, dtype),
        "dec_attn": init_attn(gen, cfg, dtype),
        "dec_mlp": init_mlp(gen, cfg, dtype),
        "xattn": init_attn(gen, cfg, dtype),
        "enc_on": _ones(gen, (), dtype),
        "dec_on": _ones(gen, (), dtype),
    }


def cross_attend(p, h, enc, cfg, ctx: ShardCtx):
    """``h + o`` of the decoder's cross-attention on the encoder stream
    ``enc`` (b, s_enc, d): q from the normed ``h``, k and v from ``enc``
    itself (no norm, no rope), non-causal, as the JAX ``dec_f``."""
    b, sd, _ = h.shape
    s_enc = enc.shape[1]
    hq, hk = cfg["n_heads"], cfg["n_kv_heads"]
    dh = _head_dim(cfg)
    hin = rmsnorm(p["ln"], h)
    q = linear(hin, p["wq"]).reshape(b, sd, hq, dh)
    k = linear(enc, p["wk"]).reshape(b, s_enc, hk, dh)
    v = linear(enc, p["wv"]).reshape(b, s_enc, hk, dh)
    km, vm = _match_kv_heads(hq, k, v, cfg, ctx)
    o = attention(q, km, vm, causal=False)
    return h + linear(o.reshape(b, sd, hq * dh), p["wo"])


def encdec_forward(p, x, positions, cfg, ctx: ShardCtx):
    """``apply_encdec`` that also returns the decoder self-attention's
    roped k and v, (b, s_dec, hk, dh), for the serve cache.  x is
    concat(encoder stream, decoder stream); both streams start at position
    0.  The streams are made contiguous (the norm kernel reads rows of a
    contiguous tensor): a no-op at b = 1."""
    s_enc = cfg["s_enc"]
    s_dec = x.shape[1] - s_enc
    xe, xd = x[:, :s_enc].contiguous(), x[:, s_enc:].contiguous()
    pe, pd = positions[:s_enc], positions[:s_dec]

    h = attn_forward(p["enc_attn"], xe, pe, cfg, ctx, causal=False)[0]
    xe = xe + p["enc_on"] * (apply_mlp(p["enc_mlp"], h, cfg, ctx) - xe)

    h, k, v = attn_forward(p["dec_attn"], xd, pd, cfg, ctx)
    h = cross_attend(p["xattn"], h, xe, cfg, ctx)
    xd = xd + p["dec_on"] * (apply_mlp(p["dec_mlp"], h, cfg, ctx) - xd)
    return torch.cat([xe, xd], dim=1), k, v


def apply_encdec(p, x, positions, cfg, ctx: ShardCtx):
    return encdec_forward(p, x, positions, cfg, ctx)[0]


# --------------------------------------------------------------------- #
# registry
# --------------------------------------------------------------------- #
LAYER_KINDS: Dict[str, Tuple[Callable, Callable]] = {
    "attn": (init_attn, lambda p, x, pos, cfg, ctx: apply_attn(p, x, pos, cfg, ctx)),
    "attn_local": (
        init_attn,
        lambda p, x, pos, cfg, ctx: apply_attn(
            p, x, pos, cfg, ctx, window=_window("attn_local", cfg)
        ),
    ),
    "mlp": (init_mlp, lambda p, x, pos, cfg, ctx: apply_mlp(p, x, cfg, ctx)),
    "mla": (init_mla, apply_mla),
    "moe": (init_moe, lambda p, x, pos, cfg, ctx: apply_moe(p, x, cfg, ctx)),
    "slstm": (init_slstm, lambda p, x, pos, cfg, ctx: apply_slstm(p, x, cfg, ctx)),
    "mlstm": (init_mlstm, lambda p, x, pos, cfg, ctx: apply_mlstm(p, x, cfg, ctx)),
    "rglru": (init_rglru, lambda p, x, pos, cfg, ctx: apply_rglru(p, x, cfg, ctx)),
    "encdec": (init_encdec, apply_encdec),
}


def init_layer(kind: str, gen: torch.Generator, cfg, ctx: ShardCtx, dtype):
    _check_kind(kind)
    return LAYER_KINDS[kind][0](gen, cfg, dtype)


def apply_layer(kind: str, params, x, positions, cfg, ctx: ShardCtx):
    _check_kind(kind)
    return LAYER_KINDS[kind][1](params, x, positions, cfg, ctx)



def apply_block(kinds: Tuple[str, ...], mask, params, x, positions, cfg, ctx: ShardCtx):
    """One architectural block (several sub-kinds) with its padding mask
    folded in: a padded block (mask 0) is an exact no-op with zero grads.
    The unit the F/B/W split works on (``models/lm.py::ChunkFBW``)."""
    xb = x
    for ki, kind in enumerate(kinds):
        xb = apply_layer(kind, params[ki], xb, positions, cfg, ctx)
    m = mask.to(x.dtype)
    return m * xb + (1.0 - m) * x


# --------------------------------------------------------------------- #
# cross entropy (sink), tp=1
# --------------------------------------------------------------------- #
def vocab_parallel_ce(logits_loc, labels, ctx: ShardCtx, vocab: int):
    """logits_loc (b, s, V_pad) -- the whole vocab at tp=1; labels (b, s).
    Mean token CE in fp32; the max-shift carries no gradient, as in the
    JAX package (it cancels analytically)."""
    v_l = logits_loc.shape[-1]
    off = ctx.index() * v_l
    z = logits_loc.float()
    zmax = torch.max(z, dim=-1).values.detach()
    z = z - zmax[..., None]
    sumexp = torch.sum(torch.exp(z), dim=-1)
    local_lab = labels - off
    in_range = (local_lab >= 0) & (local_lab < v_l)
    safe = torch.clamp(local_lab, 0, v_l - 1)
    picked = torch.gather(z, -1, safe[..., None])[..., 0]
    picked = torch.where(in_range, picked, torch.zeros_like(picked))
    return torch.mean(torch.log(sumexp) - picked)
