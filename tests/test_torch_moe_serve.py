"""Reduced ``qwen2_moe_a2_7b`` served by the port against the JAX package,
in float32 on the CPU: a prefill of 16 tokens and 3 greedy decode steps,
the logits within 1e-4 and the greedy tokens equal, at p=2 (the JAX
``make_serve_chunk`` stage by stage) and p=1 (the JAX ``InferExecutor``).
Each moe layer of a decode step routes its b tokens alone, as the JAX
``decode_block`` does; ``prefill_block`` and ``decode_block`` of the kind
keep no cache and equal ``apply_moe``."""

import dataclasses

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
from test_torch_serve_parity import _jax_serve_by_stage, _jax_serve_executor  # noqa: E402

ARCH = "qwen2_moe_a2_7b"
SERVE_TOL = 1e-4
BLOCK_TOL = 1e-5


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("p", [1, 2])
def test_moe_serve_matches_jax_f32(p):
    m, b, s, new = 2, 2, 16, 3
    cfg_j, cfg_t = jax_get_reduced(ARCH), get_reduced(ARCH)
    spec = jlm.RunSpec(p=p, n_chunks=1, microbatch=b, seq_len=s, m=m)
    stacked_j, shared_j = jlm.init_params(cfg_j, spec, JaxPlacement.linear(p))
    stacked_t, shared_t = params_from_numpy(_np(stacked_j), _np(shared_j), device="cpu")
    prompts = np.random.default_rng(1).integers(0, cfg_t.vocab, (m, b, s))
    if p == 1:
        ref = _jax_serve_executor(cfg_j, stacked_j, shared_j, prompts, new)
    else:
        ref = _jax_serve_by_stage(cfg_j, stacked_j, shared_j, prompts, new, p)
    res = launcher.serve(cfg_t, stacked_t, shared_t, prompts, p=p, new_tokens=new)
    assert len(res.logits) == len(ref) == new + 1
    for i, (got, want) in enumerate(zip(res.logits, ref)):
        assert tuple(got.shape) == want.shape == (m, b, cfg_t.vocab), i
        np.testing.assert_allclose(got.float().numpy(), want, rtol=SERVE_TOL, atol=SERVE_TOL)
        np.testing.assert_array_equal(res.tokens[..., i].numpy(), want.argmax(-1))


@pytest.mark.parametrize("mode", ["prefill", "decode"])
def test_moe_serve_blocks_match_jax(mode):
    cfg = layer_cfg(get_reduced(ARCH))
    p_j = jmod.init_moe(jax.random.PRNGKey(3), cfg, jnp.float32)
    p_t = {k: to_torch(np.asarray(v)) for k, v in p_j.items()}
    b, s = 2, (8 if mode == "prefill" else 1)
    x = np.random.default_rng(5).standard_normal((b, s, cfg["d_model"])).astype(np.float32)
    assert tserve.cache_spec("moe", cfg, tmod.ShardCtx(), b, 12, torch.float32,
                             device="cpu") == {}
    if mode == "prefill":
        yj, cj = jserve.prefill_block("moe", p_j, jnp.asarray(x), {}, cfg, jmod.ShardCtx(),
                                      jnp.arange(s))
        yt, ct = tserve.prefill_block("moe", p_t, torch.from_numpy(x), {}, cfg,
                                      tmod.ShardCtx(), torch.arange(s))
    else:
        yj, cj = jserve.decode_block("moe", p_j, jnp.asarray(x), {}, 7, cfg, jmod.ShardCtx())
        yt, ct = tserve.decode_block("moe", p_t, torch.from_numpy(x), {}, 7, cfg,
                                     tmod.ShardCtx())
    assert ct == {} and dict(cj) == {}
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=BLOCK_TOL, atol=BLOCK_TOL)
    np.testing.assert_array_equal(
        yt.numpy(), tmod.apply_moe(p_t, torch.from_numpy(x), cfg, tmod.ShardCtx()).numpy())


def test_moe_serve_launcher_on_the_cpu(capsys):
    res = launcher.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--pipe-size", "2",
                         "--groups", "2", "--prompt-len", "12", "--new-tokens", "3"])
    assert capsys.readouterr().out.splitlines()[-1] == "OK"
    assert tuple(res.tokens.shape) == (2, 2, 4)
    assert all(bool(torch.isfinite(lg).all()) for lg in res.logits)


def test_full_width_moe_config_is_the_published_one():
    """Full qwen2-moe-a2.7b: 60 routed experts of 1408 (top-4) and 4 shared
    (5632 wide), MHA 16 x 128, 14.32 B parameters; a prefill of 1024 tokens
    gets 86 slots an expert, a decode step of 2 tokens 4."""
    from repro_torch.configs import get_config
    from repro_torch.core.planner import state_bytes

    cfg = get_config(ARCH)
    lcfg = layer_cfg(cfg)
    assert tmod.moe_capacity(lcfg, 1024) == 86 and tmod.moe_capacity(lcfg, 2) == 4
    st = state_bytes(dataclasses.replace(cfg, n_layers=24), 1, 1)
    n_params = st.params_card / 2  # bf16 weights but the fp32 routers and the mask
    assert 14.2e9 < n_params < 14.4e9
