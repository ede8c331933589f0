"""Reduced ``deepseek_v3_671b`` (mla + moe blocks) served by the port against
the JAX package, in float32 on the CPU.

* The ``mla`` blocks: ``cache_spec`` (c (b, S, kv_lora_rank), kr (b, S,
  qk_rope_head_dim)), ``prefill_block`` (the forward's c and roped kr
  written at [0, s)) and the absorbed ``decode_block`` (the latent query
  through ``wuk``, scores against c and kr, the latent context through
  ``wuv``) against the JAX ones within 1e-5, outputs and caches.
* The whole serve at p in {1, 2} (the JAX ``make_serve_chunk`` stage by
  stage) over 3 seeds: a prefill of 16 tokens and 3 greedy decode steps,
  logits within 2e-6 and the greedy tokens equal, and every moe call's
  top-k choice identical in both packages (logged by call, compared as
  the set of calls of each serve step).
* The absorbed decode equals the unabsorbed forward at the decoded
  position within 1e-5 (the two forms are the same function).
* The serving launcher takes ``--arch deepseek_v3_671b`` on the CPU.
"""

import contextlib

import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_reduced as jax_get_reduced  # noqa: E402
from repro.core.schedules.ir import Placement as JaxPlacement  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import modules as jmod  # noqa: E402
from repro.models import serve as jserve  # noqa: E402

from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.interop import params_from_numpy, to_torch  # noqa: E402
from repro_torch.launch import serve as launcher  # noqa: E402
from repro_torch.models import modules as tmod  # noqa: E402
from repro_torch.models import serve as tserve  # noqa: E402
from repro_torch.models.lm import layer_cfg  # noqa: E402
from test_torch_serve_parity import _jax_serve_by_stage  # noqa: E402

ARCH = "deepseek_v3_671b"
SERVE_TOL = 2e-6
BLOCK_TOL = 1e-5


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _mla_params(seed=3):
    cfg = layer_cfg(get_reduced(ARCH))
    p_j = jmod.init_mla(jax.random.PRNGKey(seed), cfg, jnp.float32)
    return cfg, p_j, {k: to_torch(np.asarray(v)) for k, v in p_j.items()}


def test_mla_cache_spec_is_the_latent():
    cfg = layer_cfg(get_reduced(ARCH))
    c = tserve.cache_spec("mla", cfg, tmod.ShardCtx(), 2, 12, torch.float32, device="cpu",
                          lead=(3,))
    cj = jserve.cache_spec("mla", cfg, jmod.ShardCtx(), 2, 12, jnp.float32)
    assert {k: tuple(v.shape) for k, v in c.items()} == {"c": (3, 2, 12, 16), "kr": (3, 2, 12, 8)}
    assert {k: (3,) + tuple(v.shape) for k, v in cj.items()} == \
        {k: tuple(v.shape) for k, v in c.items()}


@pytest.mark.parametrize("mode", ["prefill", "decode"])
def test_mla_serve_blocks_match_jax(mode):
    cfg, p_j, p_t = _mla_params()
    b, s, S = 2, 8, 12
    rng = np.random.default_rng(5)
    x = rng.standard_normal((b, s, cfg["d_model"])).astype(np.float32)
    cj = jserve.cache_spec("mla", cfg, jmod.ShardCtx(), b, S, jnp.float32)
    ct = tserve.cache_spec("mla", cfg, tmod.ShardCtx(), b, S, torch.float32, device="cpu")
    yj, cj = jserve.prefill_block("mla", p_j, jnp.asarray(x), cj, cfg, jmod.ShardCtx(),
                                  jnp.arange(s))
    yt, ct2 = tserve.prefill_block("mla", p_t, torch.from_numpy(x), ct, cfg, tmod.ShardCtx(),
                                   torch.arange(s))
    assert ct2 is ct  # written in place
    if mode == "decode":
        xd = rng.standard_normal((b, 1, cfg["d_model"])).astype(np.float32)
        yj, cj = jserve.decode_block("mla", p_j, jnp.asarray(xd), cj, s, cfg, jmod.ShardCtx())
        yt, _ = tserve.decode_block("mla", p_t, torch.from_numpy(xd), ct, s, cfg,
                                    tmod.ShardCtx())
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=BLOCK_TOL, atol=BLOCK_TOL)
    for k in ("c", "kr"):
        np.testing.assert_allclose(ct[k].numpy(), np.asarray(cj[k]), rtol=BLOCK_TOL,
                                   atol=BLOCK_TOL)
    assert not ct["c"][:, s + (mode == "decode"):].any()  # nothing past the written positions


def test_absorbed_decode_equals_the_forward():
    """Decoding position s against a cache of [0, s) gives the forward's
    output at s: the absorbed form reassociates the same products."""
    cfg, _, p_t = _mla_params(seed=4)
    b, s = 2, 9
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (b, s + 1, cfg["d_model"])).astype(np.float32))
    full = tmod.apply_mla(p_t, x, torch.arange(s + 1), cfg, tmod.ShardCtx())
    cache = tserve.cache_spec("mla", cfg, tmod.ShardCtx(), b, s + 1, torch.float32,
                              device="cpu")
    tserve.prefill_block("mla", p_t, x[:, :s].contiguous(), cache, cfg, tmod.ShardCtx(),
                         torch.arange(s))
    y, _ = tserve.decode_block("mla", p_t, x[:, s:].contiguous(), cache, s, cfg,
                               tmod.ShardCtx())
    torch.testing.assert_close(y, full[:, s:], rtol=BLOCK_TOL, atol=BLOCK_TOL)


@contextlib.contextmanager
def _route_logs():
    """Every moe call's top-k choice in both packages: the port's eagerly,
    the JAX package's from inside its jitted steps (ordered callbacks)."""
    logs = {"port": [], "jax": []}
    real_t, real_j = tmod._moe_route, jmod._moe_route

    def port(p, tok, cfg):
        out = real_t(p, tok, cfg)
        logs["port"].append(out[1].numpy().copy())
        return out

    def jax_route(p, tok, cfg):
        out = real_j(p, tok, cfg)
        jax.debug.callback(lambda t: logs["jax"].append(np.asarray(t).copy()), out[1],
                           ordered=True)
        return out

    tmod._moe_route, jmod._moe_route = port, jax_route
    try:
        yield logs
    finally:
        tmod._moe_route, jmod._moe_route = real_t, real_j


def _by_step(log, m, p, layers_a_stage, new):
    """The calls of each serve step (prefill, then each decode step), as a
    sorted list of their choices: both packages make m * p * g calls a
    step, in their own walk orders."""
    per = m * p * layers_a_stage
    assert len(log) == per * (new + 1)
    return [sorted(a.astype(np.int64).tobytes() for a in log[i * per:(i + 1) * per])
            for i in range(new + 1)]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("p", [1, 2])
def test_mla_serve_matches_jax_f32(p, seed):
    m, b, s, new = 2, 2, 16, 3
    cfg_j, cfg_t = jax_get_reduced(ARCH), get_reduced(ARCH)
    spec = jlm.RunSpec(p=p, n_chunks=1, microbatch=b, seq_len=s, m=m)
    stacked_j, shared_j = jlm.init_params(cfg_j, spec, JaxPlacement.linear(p),
                                          key=jax.random.PRNGKey(seed))
    stacked_t, shared_t = params_from_numpy(_np(stacked_j), _np(shared_j), device="cpu")
    prompts = np.random.default_rng(seed + 1).integers(0, cfg_t.vocab, (m, b, s))
    with _route_logs() as logs:
        ref = _jax_serve_by_stage(cfg_j, stacked_j, shared_j, prompts, new, p)
        jax.effects_barrier()
        res = launcher.serve(cfg_t, stacked_t, shared_t, prompts, p=p, new_tokens=new)
    assert len(res.logits) == len(ref) == new + 1
    for i, (got, want) in enumerate(zip(res.logits, ref)):
        assert tuple(got.shape) == want.shape == (m, b, cfg_t.vocab), i
        np.testing.assert_allclose(got.float().numpy(), want, rtol=SERVE_TOL, atol=SERVE_TOL)
        np.testing.assert_array_equal(res.tokens[..., i].numpy(), want.argmax(-1))
    g = cfg_t.n_layers // p
    assert _by_step(logs["port"], m, p, g, new) == _by_step(logs["jax"], m, p, g, new)


def test_mla_serve_launcher_on_the_cpu(capsys):
    res = launcher.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--pipe-size", "2",
                         "--groups", "2", "--prompt-len", "12", "--new-tokens", "3"])
    assert capsys.readouterr().out.splitlines()[-1] == "OK"
    assert tuple(res.tokens.shape) == (2, 2, 4)
    assert all(bool(torch.isfinite(lg).all()) for lg in res.logits)
