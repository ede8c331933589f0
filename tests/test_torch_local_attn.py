"""The port's ``attn_local`` kind (gemma2's sliding window with the logit
softcap) against the JAX package, in float32 on the CPU.

* ``attention`` with a window: dense and query-blocked, softcap on and off,
  and ``_attend_dense`` at a query offset, within 1e-5.
* The ``attn_local`` block's F/B/W split (alone and with its mlp, mask 1 and
  0) against the JAX split, as ``test_block_split_matches_jax`` does for
  ``attn``: forward, dx and W's gradients within 1e-5, 4 wgrad calls for the
  local attention's linears, none in B.
* The ring cache: after a prefill of s tokens, decoding token s matches the
  last row of the JAX ``apply_attn`` over s + 1 tokens for s = W-2, W, W+2,
  2W and 2W+3 (past the window, and not a multiple of it), and the JAX
  ``decode_block`` (output and cache) where the JAX ring is right: s = W-2,
  W and 2W.  The JAX prefill of a prompt longer than the ring stores the
  tail from slot 0, which its decode misreads unless s is a multiple of the
  ring; at W+2 and 2W+3 the test shows that fault, and the port's ring
  holding position P in slot P % W.
* Reduced gemma2 served with a 10-token prompt (W+2) and 8 new tokens, so
  decode wraps the ring: every decoded step's logits equal the last
  position of a prefill one token longer, within 2e-4 (the port's own
  consistency check, as ``test_prefill_then_decode_consistency``).
"""

import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.passes import auto_fbw  # noqa: E402
from repro.models import modules as jmod  # noqa: E402
from repro.models import serve as jserve  # noqa: E402

from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.core.passes import autograd_fbw  # noqa: E402
from repro_torch.core.schedules.ir import Placement  # noqa: E402
from repro_torch.interop import to_torch  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.launch.serve import serve  # noqa: E402
from repro_torch.models import modules as tmod  # noqa: E402
from repro_torch.models import serve as tserve  # noqa: E402
from repro_torch.models.lm import RunSpec, init_params, layer_cfg  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

ARCH = "gemma2_2b"
TOL = 1e-5
W = 8  # the reduced gemma2's window
assert dict(get_reduced(ARCH).extras)["window"] == W


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().cpu().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _qkv(seed, sq, sk=None, h=4, d=8):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((2, sq, h, d)) * 2).astype(np.float32)
    k, v = ((rng.standard_normal((2, sk or sq, h, d)) * 2).astype(np.float32) for _ in range(2))
    return q, k, v


# --------------------------------------------------------------------- #
# attention with a window
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("softcap", [None, 5.0])
@pytest.mark.parametrize("window", [None, 1, 5])
@pytest.mark.parametrize("block", [4, 1024], ids=["query-blocks", "dense"])
def test_windowed_attention_matches_jax(block, window, softcap):
    q, k, v = _qkv(4, 13)
    want = jmod.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
                          window=window, softcap=softcap, block=block)
    got = tmod.attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                         window=window, softcap=softcap, block=block)
    _close(got, want)


@pytest.mark.parametrize("q_offset", [3, 9])
@pytest.mark.parametrize("softcap", [None, 5.0])
def test_attend_dense_at_a_query_offset_matches_jax(q_offset, softcap):
    q, k, v = _qkv(5, 4, 13)
    want = jmod._attend_dense(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), True, 5, softcap,
                              q_offset=q_offset)
    got = tmod._attend_dense(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                             softcap, 5, q_offset=q_offset)
    _close(got, want)


def test_apply_attn_local_matches_jax_and_differs_from_global():
    cfg = layer_cfg(get_reduced(ARCH))
    pj = jmod.init_layer("attn_local", jax.random.PRNGKey(0), cfg, jmod.ShardCtx(), jnp.float32)
    pt = {k: to_torch(np.asarray(v)) for k, v in pj.items()}
    x = np.random.default_rng(1).standard_normal((2, 20, cfg["d_model"])).astype(np.float32)
    pos = np.arange(20)
    want = jmod.apply_layer("attn_local", pj, jnp.asarray(x), jnp.asarray(pos), cfg,
                            jmod.ShardCtx())
    got = tmod.apply_layer("attn_local", pt, torch.from_numpy(x), torch.from_numpy(pos), cfg,
                           tmod.ShardCtx())
    _close(got, want)
    glob = tmod.apply_layer("attn", pt, torch.from_numpy(x), torch.from_numpy(pos), cfg,
                            tmod.ShardCtx())
    assert torch.allclose(glob[:, :W], got[:, :W], rtol=TOL, atol=TOL)  # the window is whole
    assert not torch.allclose(glob[:, W:], got[:, W:], rtol=1e-3, atol=1e-3)


# --------------------------------------------------------------------- #
# the block split
# --------------------------------------------------------------------- #
@pytest.fixture
def wgrad_calls(monkeypatch):
    calls = []
    real = tops.wgrad_accum

    def counting(a, g, acc):
        calls.append((tuple(a.shape), tuple(g.shape)))
        return real(a, g, acc)

    monkeypatch.setattr(tops, "wgrad_accum", counting)
    return calls


@pytest.mark.parametrize("kinds", [("attn_local",), ("attn_local", "mlp")])
@pytest.mark.parametrize("mask", [1.0, 0.0])
def test_attn_local_block_split_matches_jax(kinds, mask, wgrad_calls):
    cfg = get_reduced(ARCH)
    lcfg = layer_cfg(cfg)
    ctx_j, ctx_t = jmod.ShardCtx(), tmod.ShardCtx()
    kp = tuple(jmod.init_layer(k, jax.random.PRNGKey(7 + i), lcfg, ctx_j, jnp.float32)
               for i, k in enumerate(kinds))
    params_j = (jnp.float32(mask), kp)
    params_t = (torch.tensor(mask), tuple({k: to_torch(np.asarray(v)) for k, v in d.items()}
                                          for d in kp))
    rng = np.random.default_rng(3)
    b, s = 2, 16
    x = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    dy = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    acc = jax.tree_util.tree_map(
        lambda a: (rng.standard_normal(np.shape(a)) * 0.1).astype(np.float32), params_j)
    side_j, side_t = {"positions": jnp.arange(s)}, {"positions": torch.arange(s)}

    jax_mod = auto_fbw(lambda p, xx, sd: jmod.apply_block(kinds, p[0], p[1], xx, sd["positions"],
                                                           lcfg, ctx_j))
    port_mod = autograd_fbw(lambda p, xx, sd: tmod.apply_block(kinds, p[0], p[1], xx,
                                                               sd["positions"], lcfg, ctx_t))
    y_j, res_j = jax_mod.fwd(params_j, jnp.asarray(x), side_j)
    dx_j, wctx_j = jax_mod.bwd_x(params_j, res_j, jnp.asarray(dy), side_j)
    w_j = jax_mod.bwd_w(params_j, wctx_j, side_j, acc=jax.tree_util.tree_map(jnp.asarray, acc))
    y_t, res_t = port_mod.fwd(params_t, torch.from_numpy(x), side_t)
    dx_t, wctx_t = port_mod.bwd_x(params_t, res_t, torch.from_numpy(dy), side_t)
    _close(y_t, y_j)
    _close(dx_t, dx_j)
    assert wgrad_calls == []  # B computes no weight product
    w_t = port_mod.bwd_w(params_t, wctx_t, side_t,
                         acc=tree_map(lambda a: torch.from_numpy(np.array(a)), acc))
    assert len(wgrad_calls) == sum({"attn_local": 4, "mlp": 3}[k] for k in kinds)
    got, want = tree_leaves(w_t), jax.tree_util.tree_leaves(w_j)
    assert len(got) == len(want)
    for a, b_ in zip(got, want):
        assert tuple(a.shape) == tuple(b_.shape)
        _close(a, b_)


# --------------------------------------------------------------------- #
# the ring cache
# --------------------------------------------------------------------- #
PROMPTS = [W - 2, W, W + 2, 2 * W, 2 * W + 3]
JAX_RING_RIGHT = [W - 2, W, 2 * W]  # s <= W, or a multiple of W


def _ring_setup(s, seed=0, b=2):
    cfg = layer_cfg(get_reduced(ARCH))
    pj = jmod.init_layer("attn_local", jax.random.PRNGKey(seed), cfg, jmod.ShardCtx(),
                         jnp.float32)
    pt = {k: to_torch(np.asarray(v)) for k, v in pj.items()}
    x = np.random.default_rng(seed + 1).standard_normal(
        (b, s + 1, cfg["d_model"])).astype(np.float32)
    return cfg, pj, pt, x


def _port_prefill_decode(cfg, pt, x, s):
    """The port: prefill s tokens into a cache for s + 1, then decode token s."""
    ctx = tmod.ShardCtx()
    cache = tserve.cache_spec("attn_local", cfg, ctx, x.shape[0], s + 1, torch.float32,
                              device="cpu")
    assert cache["k"].shape[1] == min(s + 1, W)
    head, last = (torch.from_numpy(np.ascontiguousarray(a)) for a in (x[:, :s], x[:, s:]))
    tserve.prefill_block("attn_local", pt, head, cache, cfg, ctx, torch.arange(s))
    y, cache = tserve.decode_block("attn_local", pt, last, cache, s, cfg, ctx)
    return y, cache


def _jax_forward(cfg, pj, x):
    """The JAX ``attn_local`` layer over all of x."""
    fn = jax.jit(lambda p_, x_, pos: jmod.apply_layer("attn_local", p_, x_, pos, cfg,
                                                       jmod.ShardCtx()))
    return np.asarray(fn(pj, jnp.asarray(x), jnp.arange(x.shape[1])))


@pytest.mark.parametrize("s", PROMPTS)
def test_ring_decode_matches_the_jax_forward(s):
    cfg, pj, pt, x = _ring_setup(s)
    want = _jax_forward(cfg, pj, x)[:, s:]
    y, cache = _port_prefill_decode(cfg, pt, x, s)
    _close(y, want)
    # slot i holds the newest position P <= s with P % Sc == i: the k of
    # the forward at P (rope'd), taken from a prefill of all s + 1 tokens
    sc = cache["k"].shape[1]
    full = tserve.cache_spec("attn", cfg, tmod.ShardCtx(), x.shape[0], s + 1, torch.float32,
                             device="cpu")
    tserve.prefill_block("attn", pt, torch.from_numpy(x), full, cfg, tmod.ShardCtx(),
                         torch.arange(s + 1))
    for i in range(sc):
        P = s - (s - i) % sc
        _close(cache["k"][:, i], full["k"][:, P].numpy())
        _close(cache["v"][:, i], full["v"][:, P].numpy())


def _jax_prefill_decode(cfg, pj, x, s):
    """The JAX prefill of s tokens, then its decode of token s."""
    ctx = jmod.ShardCtx()

    @jax.jit
    def run(p_, head, last):
        cache = jserve.cache_spec("attn_local", cfg, ctx, x.shape[0], s + 1, jnp.float32)
        _, cache = jserve.prefill_block("attn_local", p_, head, cache, cfg, ctx, jnp.arange(s))
        return jserve.decode_block("attn_local", p_, last, cache, s, cfg, ctx)

    return run(pj, jnp.asarray(x[:, :s]), jnp.asarray(x[:, s:]))


@pytest.mark.parametrize("s", JAX_RING_RIGHT)
def test_ring_decode_matches_jax_decode(s):
    cfg, pj, pt, x = _ring_setup(s, seed=2)
    y_j, cache_j = _jax_prefill_decode(cfg, pj, x, s)
    y_t, cache_t = _port_prefill_decode(cfg, pt, x, s)
    _close(y_t, y_j)
    for name in ("k", "v"):
        _close(cache_t[name], cache_j[name])


@pytest.mark.parametrize("s", sorted(set(PROMPTS) - set(JAX_RING_RIGHT)))
def test_jax_ring_misreads_a_tail_that_is_not_a_whole_ring(s):
    """Where the JAX prefill's tail layout and its decode's slot rule part,
    the JAX decode leaves its own forward and the port's does not."""
    cfg, pj, pt, x = _ring_setup(s, seed=3)
    want = _jax_forward(cfg, pj, x)[:, s:]
    y_j, _ = _jax_prefill_decode(cfg, pj, x, s)
    y_t, _ = _port_prefill_decode(cfg, pt, x, s)
    _close(y_t, want)
    assert np.abs(np.asarray(y_j) - want).max() > 1e-2


def test_gemma2_decode_wraps_the_ring_consistently():
    cfg = get_reduced(ARCH)
    p, m, b, s, new = 2, 2, 2, W + 2, W
    stacked, shared = init_params(cfg, RunSpec(p=p, n_chunks=1, microbatch=b, seq_len=s, m=m),
                                  Placement.linear(p), seed=5, device="cpu")
    prompts = np.random.default_rng(5).integers(0, cfg.vocab, (m, b, s))
    res = serve(cfg, stacked, shared, prompts, p=p, new_tokens=new)
    toks = res.tokens.numpy()
    for i in range(1, new + 1):
        longer = np.concatenate([prompts, toks[..., :i]], axis=-1)
        ref = serve(cfg, stacked, shared, longer, p=p, new_tokens=0)
        torch.testing.assert_close(res.logits[i], ref.logits[0], rtol=2e-4, atol=2e-4)
