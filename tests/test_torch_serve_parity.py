"""Parity of the port's serving path (``src/repro_torch``) with the JAX package.

Reduced internlm2 in float32.  Weights come from the JAX ``init_params`` and
are carried over with ``repro_torch.interop.params_from_numpy``; inputs and
tokens come from numpy with a fixed seed.  On the CPU the port's RMSNorm is
its plain version.

Tolerances: f32 blocks within 1e-5 (the two frameworks sum in other orders
and use other exp/rsqrt implementations; a few f32 ulps per op over a
handful of ops); whole-serve logits within rtol=atol=1e-4 (the same per-op
rounding, compounded over the depth, prefill and three decode steps); bf16
logits within 5e-2 (bf16 keeps 8 mantissa bits and both frameworks round
after every product, at places that differ: a few bf16 ulps of logits that
reach ~0.5).
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.experimental.shard_map import shard_map  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs import get_reduced as jax_get_reduced  # noqa: E402
from repro.core.infer_executor import InferExecutor as JaxInferExecutor  # noqa: E402
from repro.core.infer_executor import compile_infer_plan as jax_compile_infer_plan  # noqa: E402
from repro.core.schedules.ir import Placement as JaxPlacement  # noqa: E402
from repro.models import modules as jmod  # noqa: E402
from repro.models import serve as jserve  # noqa: E402
from repro.models.lm import RunSpec as JaxRunSpec  # noqa: E402
from repro.models.lm import _embed_lookup as jax_embed_lookup  # noqa: E402
from repro.models.lm import init_params as jax_init_params  # noqa: E402

from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.interop import params_from_numpy, to_torch  # noqa: E402
from repro_torch.launch.serve import serve  # noqa: E402
from repro_torch.models import modules as tmod  # noqa: E402
from repro_torch.models import serve as tserve  # noqa: E402
from repro_torch.models.lm import RunSpec, layer_cfg  # noqa: E402

ARCH = "internlm2_1_8b"
F32_BLOCK_TOL = 1e-5
F32_SERVE_TOL = 1e-4
BF16_SERVE_TOL = 5e-2


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want, tol):
    np.testing.assert_allclose(
        got.detach().float().cpu().numpy(), np.asarray(want, np.float32), rtol=tol, atol=tol
    )


# --------------------------------------------------------------------- #
# per block
# --------------------------------------------------------------------- #
def _block_setup(kind, seed=0, b=2, s=16):
    cfg = get_reduced(ARCH)
    lcfg = layer_cfg(cfg)
    pj = jmod.init_layer(kind, jax.random.PRNGKey(seed), lcfg, jmod.ShardCtx(), jnp.float32)
    pt = {k: to_torch(np.asarray(v)) for k, v in pj.items()}
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    return lcfg, pj, pt, x


def test_apply_attn_parity():
    lcfg, pj, pt, x = _block_setup("attn")
    pos = np.arange(x.shape[1])
    want = jmod.apply_attn(pj, jnp.asarray(x), jnp.asarray(pos), lcfg, jmod.ShardCtx())
    got = tmod.apply_attn(pt, torch.from_numpy(x), torch.from_numpy(pos), lcfg, tmod.ShardCtx())
    _close(got, want, F32_BLOCK_TOL)


def test_apply_mlp_parity():
    lcfg, pj, pt, x = _block_setup("mlp", seed=1)
    want = jmod.apply_mlp(pj, jnp.asarray(x), lcfg, jmod.ShardCtx())
    got = tmod.apply_mlp(pt, torch.from_numpy(x), lcfg, tmod.ShardCtx())
    _close(got, want, F32_BLOCK_TOL)


@pytest.mark.parametrize("block", [4, 1024])
def test_attention_parity(block):
    """Dense (s <= 2 * block) and query-blocked (s > 2 * block) attention."""
    rng = np.random.default_rng(4)
    q, k, v = (rng.standard_normal((2, 12, 4, 8)).astype(np.float32) for _ in range(3))
    want = jmod.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
                          block=block)
    got = tmod.attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                         block=block)
    _close(got, want, F32_BLOCK_TOL)


@pytest.mark.parametrize("kind", ["attn", "mlp"])
def test_prefill_then_decode_block_parity(kind):
    """prefill_block then decode_block at pos s: outputs and caches."""
    b, s, S = 2, 16, 20
    lcfg, pj, pt, x = _block_setup(kind, seed=2, b=b, s=s)
    ctx_j, ctx_t = jmod.ShardCtx(), tmod.ShardCtx()
    cj = jserve.cache_spec(kind, lcfg, ctx_j, b, S, jnp.float32)
    ct = tserve.cache_spec(kind, lcfg, ctx_t, b, S, torch.float32, device="cpu")
    pos = np.arange(s)
    yj, cj = jserve.prefill_block(kind, pj, jnp.asarray(x), cj, lcfg, ctx_j, jnp.asarray(pos))
    yt, ct2 = tserve.prefill_block(kind, pt, torch.from_numpy(x), ct, lcfg, ctx_t,
                                   torch.from_numpy(pos))
    assert ct2 is ct  # the cache is written in place
    _close(yt, yj, F32_BLOCK_TOL)
    assert sorted(ct) == sorted(cj)
    for name in cj:
        _close(ct[name], cj[name], F32_BLOCK_TOL)

    xd = np.random.default_rng(3).standard_normal((b, 1, lcfg["d_model"])).astype(np.float32)
    yj, cj = jserve.decode_block(kind, pj, jnp.asarray(xd), cj, s, lcfg, ctx_j)
    yt, ct = tserve.decode_block(kind, pt, torch.from_numpy(xd), ct, s, lcfg, ctx_t)
    _close(yt, yj, F32_BLOCK_TOL)
    for name in cj:
        _close(ct[name], cj[name], F32_BLOCK_TOL)


def test_cache_view_aliases_the_stacked_buffer():
    """Trouble spot: the group's cache slice must alias the stored buffer."""
    cfg = get_reduced(ARCH)
    spec = RunSpec(p=2, n_chunks=1, microbatch=2, seq_len=4, m=3)
    _, cache_init = tserve.make_serve_chunk(cfg, spec, "decode")
    caches = cache_init(2, 8, device="cpu", lead=(2, 3))
    view = caches[0][0]["k"][1, 2]
    view[:, 5] = 7.0
    assert torch.all(caches[0][0]["k"][1, 2, :, 5] == 7.0)
    assert torch.count_nonzero(caches[0][0]["k"]) == view[:, 5].numel()


@pytest.mark.parametrize("kind", ("mla", "moe", "slstm", "mlstm", "rglru", "encdec"))
def test_unported_kinds_raise(kind):
    """The JAX kinds beyond the dense ones: each raises naming itself until
    it is ported (all since; each initialises and decodes)."""
    cfg = layer_cfg(get_reduced(ARCH))
    if kind in tmod.PORTED_KINDS:
        assert kind not in tmod.UNPORTED_KINDS
        arch = {"moe": "qwen2_moe_a2_7b", "mla": "deepseek_v3_671b", "encdec": "whisper_tiny",
                "slstm": "xlstm_350m", "mlstm": "xlstm_350m",
                "rglru": "recurrentgemma_9b"}[kind]
        cfg = layer_cfg(get_reduced(arch))
        d = cfg["d_model"]
        p = tmod.init_layer(kind, torch.Generator(), cfg, tmod.ShardCtx(), torch.float32)
        cache = tserve.cache_spec(kind, cfg, tmod.ShardCtx(), 2, 4, torch.float32, device="cpu")
        y, cache = tserve.decode_block(kind, p, torch.zeros(2, 1, d), cache, 0, cfg,
                                       tmod.ShardCtx())
        assert tuple(y.shape) == (2, 1, d)
        assert sorted(cache) == {"moe": [], "mla": ["c", "kr"], "encdec": ["enc", "k", "v"],
                                 "slstm": ["c", "m", "n"], "mlstm": ["C"], "rglru": ["h"]}[kind]
        return
    assert kind in tmod.UNPORTED_KINDS
    with pytest.raises(NotImplementedError, match=kind):
        tmod.init_layer(kind, torch.Generator(), cfg, tmod.ShardCtx(), torch.float32)
    with pytest.raises(NotImplementedError, match=kind):
        tserve.decode_block(kind, {}, torch.zeros(2, 1, 48), {}, 0, cfg, tmod.ShardCtx())


# --------------------------------------------------------------------- #
# whole serve: prefill + 3 decode steps
# --------------------------------------------------------------------- #
def _jax_serve_executor(cfg, stacked, shared, prompts, new_tokens):
    """p=1 reference: the JAX InferExecutor under a one-device shard_map."""
    m, b, s = prompts.shape
    placement = JaxPlacement.linear(1)
    mesh = jax.make_mesh((1,), ("pipe",))
    S = s + new_tokens
    caches = None
    out = []
    toks = None
    for i in range(new_tokens + 1):
        mode = "prefill" if i == 0 else "decode"
        spec = JaxRunSpec(p=1, n_chunks=1, microbatch=b, seq_len=s if i == 0 else 1, m=m)
        program, cache_init, _ = jserve.build_serve_program(cfg, spec, placement, mode)
        step = JaxInferExecutor(program, jax_compile_infer_plan(placement, m), "pipe").build_step_fn()
        if caches is None:
            one = cache_init(b, S)
            caches = [jax.tree_util.tree_map(lambda a: jnp.zeros((m,) + a.shape, a.dtype), one)]
        if i == 0:
            side = {"tokens": jnp.asarray(prompts),
                    "positions": jnp.broadcast_to(jnp.arange(s), (m, s))}
            pos = 0
        else:
            side = {"tokens": toks[..., None], "positions": jnp.zeros((m, 1), jnp.int32)}
            pos = s + i - 1

        def body(stacked_local, shared, side, caches, pos=pos, step=step):
            local = tuple(jax.tree_util.tree_map(lambda a: a[0], sp) for sp in stacked_local)
            return step(local, shared, side, caches, pos)

        spec_stacked = tuple(jax.tree_util.tree_map(lambda _: P("pipe"), sp) for sp in stacked)
        fn = shard_map(body, mesh=mesh, in_specs=(spec_stacked, P(), P(), P()),
                       out_specs=(P(), P()), check_rep=False)
        logits, caches = jax.jit(fn)(stacked, shared, side, caches)
        caches = list(caches)
        toks = jnp.argmax(logits, -1)
        out.append(np.asarray(logits.astype(jnp.float32)))
    return out


def _jax_serve_by_stage(cfg, stacked, shared, prompts, new_tokens, p):
    """p>1 reference: the JAX make_serve_chunk applied stage by stage."""
    m, b, s = prompts.shape
    S = s + new_tokens
    spec = JaxRunSpec(p=p, n_chunks=1, microbatch=b, seq_len=s, m=m)
    pre, cache_init, _ = jserve.make_serve_chunk(cfg, spec, "prefill")
    dec, _, _ = jserve.make_serve_chunk(cfg, spec, "decode")
    pre, dec = jax.jit(pre), jax.jit(dec)
    ctx = jmod.ShardCtx()
    params = [jax.tree_util.tree_map(lambda a: a[st], stacked[0]) for st in range(p)]
    caches = [[cache_init(b, S) for _ in range(p)] for _ in range(m)]

    def sink(y):
        yn = jmod.rmsnorm(shared["final_ln"], y[:, -1:])
        return (yn @ shared["head"])[:, 0]

    out = []
    toks = [None] * m
    for i in range(new_tokens + 1):
        step_logits = []
        for j in range(m):
            if i == 0:
                x = jax_embed_lookup(shared, jnp.asarray(prompts[j]), cfg, ctx)
                side = {"positions": jnp.arange(s)}
            else:
                x = jax_embed_lookup(shared, toks[j][:, None], cfg, ctx)
                side = {}
            for st in range(p):
                if i == 0:
                    x, caches[j][st] = pre(params[st], x, side, caches[j][st], 0)
                else:
                    x, caches[j][st] = dec(params[st], x, side, caches[j][st], s + i - 1)
            lg = sink(x)
            toks[j] = jnp.argmax(lg, -1)
            step_logits.append(np.asarray(lg.astype(jnp.float32)))
        out.append(np.stack(step_logits))
    return out


def _run_both(p, m, b=2, s=16, new_tokens=3, dtype="float32", seed=0):
    cfg_j = dataclasses.replace(jax_get_reduced(ARCH), dtype=dtype)
    cfg_t = dataclasses.replace(get_reduced(ARCH), dtype=dtype)
    spec = JaxRunSpec(p=p, n_chunks=1, microbatch=b, seq_len=s, m=m)
    stacked_j, shared_j = jax_init_params(cfg_j, spec, JaxPlacement.linear(p))
    stacked_t, shared_t = params_from_numpy(_np(stacked_j), _np(shared_j), device="cpu")
    prompts = np.random.default_rng(seed).integers(0, cfg_t.vocab, (m, b, s))
    if p == 1:
        ref = _jax_serve_executor(cfg_j, stacked_j, shared_j, prompts, new_tokens)
    else:
        ref = _jax_serve_by_stage(cfg_j, stacked_j, shared_j, prompts, new_tokens, p)
    res = serve(cfg_t, stacked_t, shared_t, prompts, p=p, new_tokens=new_tokens)
    return ref, res


@pytest.mark.parametrize("m", [2, 3])
@pytest.mark.parametrize("p", [1, 2, 4])
def test_serve_matches_jax_f32(p, m):
    ref, res = _run_both(p, m)
    assert len(res.logits) == len(ref) == 4
    for step, (got, want) in enumerate(zip(res.logits, ref)):
        assert got.shape == want.shape, step
        _close(got, want, F32_SERVE_TOL)
        np.testing.assert_array_equal(res.tokens[..., step].numpy(), want.argmax(-1))


def test_serve_matches_jax_bf16():
    ref, res = _run_both(2, 2, dtype="bfloat16")
    for got, want in zip(res.logits, ref):
        assert got.dtype == torch.bfloat16
        _close(got, want, BF16_SERVE_TOL)


def test_prefill_then_decode_consistency():
    """The port's own check: decoding token s after a prefill of s tokens
    gives the last-position logits of a prefill of s + 1 tokens."""
    cfg = get_reduced(ARCH)
    p, m, b, s = 2, 2, 2, 12
    from repro_torch.core.schedules.ir import Placement
    from repro_torch.models.lm import init_params

    stacked, shared = init_params(cfg, RunSpec(p=p, n_chunks=1, microbatch=b, seq_len=s, m=m),
                                  Placement.linear(p), seed=5, device="cpu")
    prompts = np.random.default_rng(5).integers(0, cfg.vocab, (m, b, s))
    res = serve(cfg, stacked, shared, prompts, p=p, new_tokens=1)
    longer = np.concatenate([prompts, res.tokens[..., :1].numpy()], axis=-1)
    res2 = serve(cfg, stacked, shared, longer, p=p, new_tokens=0)
    torch.testing.assert_close(res.logits[1], res2.logits[0], rtol=2e-4, atol=2e-4)
