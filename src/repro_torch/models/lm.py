"""Model assembly of the port: configs, group layout, parameters, the
split chunk modules, the embedding source and the loss sink.

Counterpart of ``src/repro/models/lm.py`` (the dense and moe families, the
latter with the ``moe`` and ``mla`` kinds; the vlm family, whose projected
patch embeddings go ahead of the tokens; the encdec family of ``encdec``
blocks over the projected frames and the decoder's tokens; the ssm family
of ``slstm`` and ``mlstm`` blocks and the hybrid one of ``rglru`` and
``attn_local`` blocks, each followed by an ``mlp``).  Blocks are
assigned to (stage, chunk) groups of uniform size; when ``n_layers`` does not divide evenly,
groups are padded with blocks whose ``mask`` leaf is 0, which leave the
activation unchanged.  Parameters keep the JAX layout: per chunk ``{"mask": (p, g), "blocks": ((kind params, ...),
...)}`` with every leaf stage-stacked on a leading ``(p,)`` axis, and shared
``{"embed": (V, d), "head": (d, V), "final_ln": (d,)}``, plus ``"front_proj":
(frontend_dim, d)`` in the vlm and encdec families.  Random weights are
drawn from an explicit ``torch.Generator`` with the JAX package's
distributions and scales (not its bits: the tests carry the JAX weights
over with ``repro_torch.interop.params_from_numpy``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..core.executor import PipelineProgram
from ..core.passes import FBWModule, SequentialFBW, autograd_fbw, linear
from ..kernels import ops
from ..tree import tree_map
from . import modules
from .modules import ShardCtx, apply_block, init_layer, pad_to_multiple, rmsnorm, vocab_parallel_ce

__all__ = [
    "ArchConfig",
    "RunSpec",
    "ChunkFBW",
    "build_program",
    "make_chunk_fn",
    "make_sink_fn",
    "side_inputs",
    "group_layout",
    "group_masks",
    "init_params",
    "init_shared",
    "init_chunk_params",
    "layer_cfg",
    "make_src",
    "front_spec",
    "front_len",
]

_TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float64": torch.float64}


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    block_pattern: Tuple[Tuple[str, ...], ...] = (("attn", "mlp"),)
    head_dim: Optional[int] = None
    extras: Tuple[Tuple[str, Any], ...] = ()  # hashable dict
    dtype: str = "float32"
    sub_quadratic: bool = False  # eligible for long_500k decode
    has_decoder: bool = True  # False only for pure encoders
    source: str = ""  # provenance note

    def extras_dict(self) -> Dict[str, Any]:
        return dict(self.extras)

    @property
    def period(self) -> int:
        return len(self.block_pattern)

    def torch_dtype(self) -> torch.dtype:
        return _TORCH_DTYPES[self.dtype]


@dataclasses.dataclass(frozen=True)
class RunSpec:
    p: int  # pipeline stages
    n_chunks: int  # chunks per stage (1, or 2 for ZB-V / interleaved)
    microbatch: int  # b per microbatch
    seq_len: int
    m: int  # number of microbatches (request groups) per pipe
    tp_axis: Optional[str] = None
    tp_size: int = 1


def layer_cfg(cfg: ArchConfig, tp_size: int = 1) -> Dict[str, Any]:
    d = dict(
        d_model=cfg.d_model,
        n_heads=cfg.n_heads,
        n_kv_heads=cfg.n_kv_heads,
        d_ff=cfg.d_ff,
        n_layers=cfg.n_layers,
        head_dim=cfg.head_dim,
        tp_size=tp_size,
    )
    d.update(cfg.extras_dict())
    return d


# --------------------------------------------------------------------- #
# block -> group assignment
# --------------------------------------------------------------------- #
def group_layout(cfg: ArchConfig, p: int, n_chunks: int) -> Tuple[Tuple[Tuple[str, ...], ...], int]:
    """Blocks per (stage, chunk) group; returns (group pattern, group size).

    Group size g is the smallest multiple of the pattern period with
    g * p * n_chunks >= n_layers, so every group is pattern-aligned.
    """
    period = cfg.period
    slots = p * n_chunks
    g = max(1, math.ceil(cfg.n_layers / slots))
    g = period * math.ceil(g / period)
    blocks = tuple(cfg.block_pattern[i % period] for i in range(g))
    return blocks, g


def group_masks(cfg: ArchConfig, p: int, n_chunks: int, placement) -> np.ndarray:
    """(p, n_chunks, g) float mask: 1 for real blocks, 0 for padding."""
    _, g = group_layout(cfg, p, n_chunks)
    masks = np.zeros((p, n_chunks, g), np.float32)
    for c in range(n_chunks):
        for k in range(p):
            s = placement.stage_of(c, k)
            start = (c * p + k) * g  # global group order along the model depth
            for bi in range(g):
                if start + bi < cfg.n_layers:
                    masks[s, c, bi] = 1.0
    return masks


# --------------------------------------------------------------------- #
# chunk modules: one split module per architectural block
# --------------------------------------------------------------------- #
def make_chunk_fn(cfg: ArchConfig, p: int, n_chunks: int, ctx: ShardCtx):
    """Whole-chunk forward (the plain path; the executor uses ChunkFBW)."""
    blocks, g = group_layout(cfg, p, n_chunks)
    lcfg = layer_cfg(cfg, ctx.tp_size)

    def chunk_fn(params, x, side):
        pos = side["positions"]
        for bi, kinds in enumerate(blocks):
            x = apply_block(kinds, params["mask"][bi], params["blocks"][bi], x, pos, lcfg, ctx)
        return x

    return chunk_fn, blocks, g


class ChunkFBW(FBWModule):
    """A pipeline chunk as a sequence of per-block split modules.

    The parameter structure is the stacked one (``{"mask": (g,), "blocks":
    (...)}``); each block module sees ``(mask[bi], blocks[bi])``.  B runs the
    blocks right to left and keeps one W-context per block (the deferred
    linears' ``(a, g)`` pairs and the finished norm-gain and mask grads); W
    rebuilds the chunk gradient from those contexts alone.
    """

    def __init__(self, cfg: ArchConfig, p: int, n_chunks: int, ctx: ShardCtx, name: str):
        blocks, _ = group_layout(cfg, p, n_chunks)
        lcfg = layer_cfg(cfg, ctx.tp_size)
        self.name = name
        self.block_kinds = blocks

        def block_fn(kinds):
            def f(params, x, side):
                mask, kp = params
                return apply_block(kinds, mask, kp, x, side["positions"], lcfg, ctx)

            return f

        self.mods = [autograd_fbw(block_fn(kinds), name=f"{name}.b{bi}")
                     for bi, kinds in enumerate(blocks)]
        self.seq = SequentialFBW(self.mods, name=name)

    @staticmethod
    def _per_block(params):
        return tuple((params["mask"][bi], blk) for bi, blk in enumerate(params["blocks"]))

    def fwd(self, params, x, side):
        return self.seq.fwd(self._per_block(params), x, side)

    def bwd_x(self, params, res, dy, side):
        return self.seq.bwd_x(self._per_block(params), res, dy, side)

    def bwd_w(self, params, wctx, side, acc):
        outs = self.seq.bwd_w(self._per_block(params), wctx, side, acc=self._per_block(acc))
        return {
            "mask": torch.stack([o[0] for o in outs]),
            "blocks": tuple(o[1] for o in outs),
        }


# --------------------------------------------------------------------- #
# parameters
# --------------------------------------------------------------------- #
PORTED_FAMILIES = ("dense", "moe", "vlm", "encdec", "ssm", "hybrid")
# a family's front ahead of the tokens: (side input, extras key of its length)
_FRONTS = {"vlm": ("patches", "n_patches"), "encdec": ("frames", "s_enc")}


def _check_family(cfg: ArchConfig) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported to repro_torch yet"
        )


def front_spec(cfg: ArchConfig) -> Optional[Tuple[str, int, int]]:
    """(side input, positions, width) of the family's front, the projected
    patch (vlm) or frame (encdec) embeddings ahead of the tokens; None
    without one."""
    if cfg.family not in _FRONTS:
        return None
    key, n = _FRONTS[cfg.family]
    ex = cfg.extras_dict()
    return key, ex[n], ex.get("frontend_dim", cfg.d_model)


def front_len(cfg: ArchConfig) -> int:
    """The positions the front puts ahead of the tokens (0 without one)."""
    spec = front_spec(cfg)
    return 0 if spec is None else spec[1]


def init_chunk_params(cfg: ArchConfig, gen: torch.Generator, stage: int, chunk: int,
                      p: int, n_chunks: int, ctx: ShardCtx, masks: np.ndarray):
    blocks, _ = group_layout(cfg, p, n_chunks)
    lcfg = layer_cfg(cfg, ctx.tp_size)
    dt = cfg.torch_dtype()
    block_params = tuple(
        tuple(init_layer(kind, gen, lcfg, ctx, dt) for kind in kinds) for kinds in blocks
    )
    return {
        "mask": torch.as_tensor(masks[stage, chunk], dtype=torch.float32, device=gen.device),
        "blocks": block_params,
    }


def init_shared(cfg: ArchConfig, gen: torch.Generator, ctx: ShardCtx):
    _check_family(cfg)
    dt = cfg.torch_dtype()
    v_pad = pad_to_multiple(cfg.vocab, max(1, ctx.tp_size))
    dev = gen.device

    def normal(shape):
        return (torch.randn(shape, generator=gen, device=dev) * 0.02).to(dt)

    shared = {
        "embed": normal((v_pad, cfg.d_model)),
        "head": normal((cfg.d_model, v_pad)),
        "final_ln": torch.zeros((cfg.d_model,), dtype=dt, device=dev),
    }
    front = front_spec(cfg)
    if front is not None:  # drawn last: the other families keep their bits
        shared["front_proj"] = normal((front[2], cfg.d_model))
    return shared


def _init_stacked_chunk(cfg: ArchConfig, gen: torch.Generator, chunk: int, p: int,
                        n_chunks: int, ctx: ShardCtx, masks: np.ndarray):
    """Chunk ``chunk``'s parameters for all p stages, stage-stacked: each
    leaf is allocated once at ``(p, ...)`` and filled stage by stage, in
    :func:`init_chunk_params`'s draw order, so the weights are its bits
    and the card never holds a stage's tree beside the stack (a
    full-width deepseek_v3_671b layer is 23 GB in bf16)."""
    shapes = []
    with modules.leaves_into(lambda shape, dtype: shapes.append(
            torch.empty(shape, dtype=dtype, device="meta")) or shapes[-1]):
        meta = init_chunk_params(cfg, gen, 0, chunk, p, n_chunks, ctx, masks)["blocks"]
    stack = [torch.empty((p, *t.shape), dtype=t.dtype, device=gen.device) for t in shapes]
    for s in range(p):
        views = iter([t[s] for t in stack])
        with modules.leaves_into(lambda shape, dtype: next(views)):
            init_chunk_params(cfg, gen, s, chunk, p, n_chunks, ctx, masks)
    index = {id(t): i for i, t in enumerate(shapes)}
    return {
        "mask": torch.as_tensor(np.ascontiguousarray(masks[:, chunk]), dtype=torch.float32,
                                device=gen.device),
        "blocks": tree_map(lambda t: stack[index[id(t)]], meta),
    }


def init_params(cfg: ArchConfig, spec: RunSpec, placement, *, seed: int = 0, device):
    """Returns (stacked stage params per chunk, shared params).

    Weights are drawn on ``device`` from ``torch.Generator(device)`` seeded
    with ``seed``; the same seed gives the same weights on one device type.
    """
    _check_family(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    ctx = ShardCtx(tp_axis=spec.tp_axis, tp_size=spec.tp_size)
    masks = group_masks(cfg, spec.p, spec.n_chunks, placement)
    stacked = tuple(_init_stacked_chunk(cfg, gen, c, spec.p, spec.n_chunks, ctx, masks)
                    for c in range(spec.n_chunks))
    shared = init_shared(cfg, gen, ctx)
    return stacked, shared


# --------------------------------------------------------------------- #
# src (embedding)
# --------------------------------------------------------------------- #
def _embed_lookup(shared, tokens: torch.Tensor, cfg: ArchConfig, ctx: ShardCtx):
    v_l = shared["embed"].shape[0]
    loc = tokens - ctx.index() * v_l
    ok = (loc >= 0) & (loc < v_l)
    safe = torch.clamp(loc, 0, v_l - 1)
    return shared["embed"][safe] * ok[..., None].to(shared["embed"].dtype)


def _embed_grad(shared, tokens: torch.Tensor, dx: torch.Tensor, ctx: ShardCtx,
                out: torch.Tensor) -> torch.Tensor:
    """Scatter-add the rows of dx, the gradient at the token positions, into
    the fp32 embedding gradient ``out``, in place (the JAX package adds a
    fresh zero table instead; this saves a (V, d) buffer per microbatch).
    On the card ``index_add_`` sums colliding rows with atomics, in no
    fixed order."""
    v_l = shared["embed"].shape[0]
    loc = tokens - ctx.index() * v_l
    ok = (loc >= 0) & (loc < v_l)
    safe = torch.clamp(loc, 0, v_l - 1)
    flat_dx = (dx * ok[..., None].to(dx.dtype)).reshape(-1, dx.shape[-1])
    return out.index_add_(0, safe.reshape(-1), flat_dx.to(out.dtype))


def make_src(cfg: ArchConfig, ctx: ShardCtx):
    """(src_fwd, src_bwd_w): the token embedding and its gradient, with the
    vlm and encdec fronts ahead of the tokens: ``side_mb[key] @
    front_proj`` (key ``patches`` or ``frames``, cast to the model dtype)
    concatenated before the embedded tokens.

    ``src_bwd_w(shared, side_mb, dx, acc)`` adds the embedding rows into
    ``acc["embed"]`` (fp32, ``acc`` like shared) in place and returns
    ``acc``; with a front it splits ``dx`` at the front's length and adds
    ``front^T @ dfront`` into ``acc["front_proj"]`` in place through
    ``kernels.ops.wgrad_accum`` (the JAX package's fp32 einsum; both
    operands in the model dtype, contiguous, at fresh or offset-0 bases)."""
    _check_family(cfg)
    front = front_spec(cfg)
    dt = cfg.torch_dtype()

    def src_fwd(shared, side_mb):
        x = _embed_lookup(shared, side_mb["tokens"], cfg, ctx)
        if front is None:
            return x
        return torch.cat([side_mb[front[0]].to(dt) @ shared["front_proj"], x], dim=1)

    def src_bwd_w(shared, side_mb, dx, acc):
        if front is not None:
            fr = side_mb[front[0]]
            nf = fr.shape[1]
            a = fr.to(dt).reshape(-1, fr.shape[-1]).contiguous()
            g = dx[:, :nf].reshape(-1, dx.shape[-1]).contiguous()
            ops.wgrad_accum(a, g, acc["front_proj"])
            dx = dx[:, nf:]
        _embed_grad(shared, side_mb["tokens"], dx, ctx, out=acc["embed"])
        return acc

    return src_fwd, src_bwd_w


def make_sink_fn(cfg: ArchConfig, ctx: ShardCtx, m: int):
    """Final RMSNorm, LM head, token CE; the loss of one microbatch / m.
    With a front, the loss covers the token positions alone: the first
    ``front_len`` positions are dropped (and the rest made contiguous for
    the norm kernel)."""
    nf = front_len(cfg)

    def sink_fn(shared, y, side_mb):
        if nf:
            y = y[:, nf:].contiguous()
        yn = rmsnorm(shared["final_ln"], y)
        logits = linear(yn, shared["head"])
        return vocab_parallel_ce(logits, side_mb["labels"], ctx, cfg.vocab) / m

    return sink_fn


# --------------------------------------------------------------------- #
# program factory and side inputs
# --------------------------------------------------------------------- #
def build_program(cfg: ArchConfig, spec: RunSpec, placement) -> PipelineProgram:
    """The executor's program: one ChunkFBW per chunk, the embedding source,
    and the sink split by the same autograd cut.  The sink's head product
    stays a plain ``torch.matmul`` in W (``fuse_wgrad=False``), as the JAX
    package leaves it to XLA."""
    _check_family(cfg)
    ctx = ShardCtx(tp_axis=spec.tp_axis, tp_size=spec.tp_size)
    src_fwd, src_bwd_w = make_src(cfg, ctx)
    chunks = [ChunkFBW(cfg, spec.p, spec.n_chunks, ctx, name=f"{cfg.name}.chunk{c}")
              for c in range(spec.n_chunks)]
    return PipelineProgram(
        chunks=chunks,
        src_fwd=src_fwd,
        src_bwd_w=src_bwd_w,
        sink=autograd_fbw(make_sink_fn(cfg, ctx, spec.m), name=f"{cfg.name}.sink",
                          fuse_wgrad=False),
        act_shape=(spec.microbatch, front_len(cfg) + spec.seq_len, cfg.d_model),
        act_dtype=cfg.torch_dtype(),
    )


def side_inputs(cfg: ArchConfig, spec: RunSpec, seed: int = 1) -> Dict[str, np.ndarray]:
    """Synthetic per-microbatch side inputs as numpy: tokens and labels
    (m, b, s), with a front its embeddings (m, b, n, frontend_dim) float32
    N(0, 1), and positions (m, n + s)."""
    _check_family(cfg)
    rng = np.random.default_rng(seed)
    m, b, s = spec.m, spec.microbatch, spec.seq_len
    side = {
        "tokens": rng.integers(0, cfg.vocab, (m, b, s)),
        "labels": rng.integers(0, cfg.vocab, (m, b, s)),
    }
    front = front_spec(cfg)
    if front is not None:
        key, n, width = front
        side[key] = rng.standard_normal((m, b, n, width)).astype(np.float32)
    s_total = front_len(cfg) + s
    side["positions"] = np.broadcast_to(np.arange(s_total), (m, s_total)).copy()
    return side
