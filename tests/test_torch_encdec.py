"""The ``encdec`` kind of the port (Whisper's joint block, concat-carry)
against the JAX package, in float32 on the CPU, at reduced
``whisper_tiny`` (d 32, 2 heads, s_enc 8, 16 decoder positions).

* The config, full and reduced, equals the JAX package's; ``encdec`` is
  ported, the recurrent kinds are not.
* ``attention(causal=False)`` with queries and keys of other lengths (the
  cross-attention's 16 decoder queries over 8 encoder keys), dense and
  query-blocked, within 1e-5 of the JAX ``attention``.
* ``apply_encdec`` within 1e-5 of the JAX one (b in {1, 2}; at b = 2 the
  two streams are strided slices, which the port makes contiguous for the
  norm kernel), its role scalars off (0) as well as on.
* Its B/W split (``autograd_fbw`` of ``apply_block``) against ``jax.grad``
  of the JAX ``apply_block``: the output and dx within 1e-5, every
  parameter gradient within 1e-4 (the 18 products, the five norm gains,
  ``enc_on``, ``dec_on`` and the mask).  B computes no weight product and
  W makes exactly 18 ``wgrad_accum`` calls, at the shapes of each stream
  (the cross-attention's k and v over the encoder's rows, q and o over
  the decoder's).
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import modules as jmod  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.core.passes import autograd_fbw  # noqa: E402
from repro_torch.interop import to_torch  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models import modules as tmod  # noqa: E402
from repro_torch.tree import keyed_leaves, tree_map  # noqa: E402
from test_torch_train_parity import wgrad_calls  # noqa: E402,F401

ARCH = "whisper_tiny"
FWD_TOL = 1e-5
GRAD_TOL = 1e-4
S_DEC = 16


def _params(seed=0, on=1.0):
    lcfg = tlm.layer_cfg(configs.get_reduced(ARCH))
    pj = jmod.init_layer("encdec", jax.random.PRNGKey(seed), lcfg, jmod.ShardCtx(), jnp.float32)
    pj = dict(pj, enc_on=jnp.float32(on), dec_on=jnp.float32(on))
    pt = tree_map(lambda a: to_torch(np.asarray(a)), jax.tree_util.tree_map(np.asarray, pj))
    return lcfg, pj, pt


def _x(lcfg, b, seed=1):
    rng = np.random.default_rng(seed)
    s = lcfg["s_enc"] + S_DEC
    return (rng.standard_normal((b, s, lcfg["d_model"])).astype(np.float32),
            rng.standard_normal((b, s, lcfg["d_model"])).astype(np.float32), np.arange(s))


@pytest.mark.parametrize("which", ["CONFIG", "reduced"])
def test_encdec_config_matches_jax(which):
    get, jget = ((configs.get_config, jconfigs.get_config) if which == "CONFIG"
                 else (configs.get_reduced, jconfigs.get_reduced))
    assert dataclasses.asdict(get(ARCH)) == dataclasses.asdict(jget(ARCH))
    assert get(ARCH).family == "encdec" and ARCH not in configs.UNPORTED_ARCHS
    assert "encdec" in tmod.PORTED_KINDS and "encdec" not in tmod.UNPORTED_KINDS
    assert tmod.UNPORTED_KINDS == ()  # the recurrent kinds, ported since
    assert sorted(configs.UNPORTED_ARCHS) == []


def test_full_width_encdec_is_the_published_one():
    cfg = configs.get_config(ARCH)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.d_ff, cfg.vocab) == (4, 384, 6, 1536,
                                                                             51865)
    assert tlm.front_spec(cfg) == ("frames", 1500, 384)
    from repro_torch.core.planner import state_bytes

    n_params = state_bytes(cfg, 1, 1).params_card / 2  # bf16 but the mask
    assert 60e6 < n_params < 62e6


@pytest.mark.parametrize("block", [4, 1024])
def test_cross_attention_matches_jax(block):
    rng = np.random.default_rng(4)
    q = rng.standard_normal((2, 16, 2, 8)).astype(np.float32)
    k, v = (rng.standard_normal((2, 8, 2, 8)).astype(np.float32) for _ in range(2))
    want = jmod.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=False,
                          block=block)
    got = tmod.attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                         causal=False, block=block)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=FWD_TOL, atol=FWD_TOL)


@pytest.mark.parametrize("on", [1.0, 0.0])
@pytest.mark.parametrize("b", [1, 2])
def test_apply_encdec_matches_jax(b, on):
    lcfg, pj, pt = _params(on=on)
    x, _, pos = _x(lcfg, b)
    want = jmod.apply_encdec(pj, jnp.asarray(x), jnp.asarray(pos), lcfg, jmod.ShardCtx())
    got = tmod.apply_encdec(pt, torch.from_numpy(x), torch.from_numpy(pos), lcfg,
                            tmod.ShardCtx())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=FWD_TOL, atol=FWD_TOL)
    if on == 0.0:
        np.testing.assert_array_equal(got.numpy(), x)


def _jax_block_grads(lcfg, pj, x, dy, pos):
    def f(params, xx):
        return jmod.apply_block(("encdec",), params[0], params[1], xx, jnp.asarray(pos), lcfg,
                                jmod.ShardCtx())

    y, vjp = jax.vjp(f, (jnp.float32(1.0), (pj,)), jnp.asarray(x))
    (g_params, dx) = vjp(jnp.asarray(dy))
    return y, dx, g_params


@pytest.mark.parametrize("b", [1, 2])
def test_encdec_split_matches_jax_grad(b, wgrad_calls):
    lcfg, pj, pt = _params(seed=3)
    x, dy, pos = _x(lcfg, b, seed=5)
    y_j, dx_j, g_j = _jax_block_grads(lcfg, pj, x, dy, pos)
    mod = autograd_fbw(lambda p, xx, sd: tmod.apply_block(("encdec",), p[0], p[1], xx,
                                                          sd["positions"], lcfg,
                                                          tmod.ShardCtx()))
    params_t = (torch.tensor(1.0), (pt,))
    side = {"positions": torch.from_numpy(pos)}
    y_t, res = mod.fwd(params_t, torch.from_numpy(x), side)
    dx_t, wctx = mod.bwd_x(params_t, res, torch.from_numpy(dy), side)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), rtol=FWD_TOL, atol=FWD_TOL)
    np.testing.assert_allclose(dx_t.numpy(), np.asarray(dx_j), rtol=FWD_TOL, atol=FWD_TOL)
    assert wgrad_calls == []  # B computes no weight product
    acc = tree_map(lambda a: torch.zeros(a.shape, dtype=torch.float32), params_t)
    g_t = mod.bwd_w(params_t, wctx, side, acc=acc)
    assert len(wgrad_calls) == 18
    s_enc, d, f = lcfg["s_enc"], lcfg["d_model"], lcfg["d_ff"]
    ne, nd = b * s_enc, b * S_DEC
    want_shapes = sorted(
        [((ne, d), (ne, d))] * 4 + [((ne, d), (ne, f))] * 2 + [((ne, f), (ne, d))]  # encoder
        + [((nd, d), (nd, d))] * 4 + [((nd, d), (nd, f))] * 2 + [((nd, f), (nd, d))]  # decoder
        + [((nd, d), (nd, d))] * 2 + [((ne, d), (ne, d))] * 2)  # cross: q, o; k, v
    assert sorted(wgrad_calls) == want_shapes
    got = dict(keyed_leaves(g_t))
    want = {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_leaves_with_path(g_j)}
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w, rtol=GRAD_TOL, atol=GRAD_TOL, err_msg=k)
    for k in ("enc_on", "dec_on", "xattn']['ln", "enc_mlp']['wd"):
        leaf = [v for key, v in got.items() if k in key]
        assert leaf and all(float(t.abs().sum()) > 0 for t in leaf), k
