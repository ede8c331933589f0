"""Reduced ``xlstm_350m`` (mlstm, slstm blocks) and ``recurrentgemma_9b``
(rglru + mlp, attn_local + mlp blocks) served by the port against the JAX
package, in float32 on the CPU.

* The recurrent kinds' serve blocks: ``cache_spec`` (fp32 state: slstm's
  c, n, m with m at -1e30; mlstm's C (b, nh, dh, dh); rglru's h (b,
  lru_width)); ``prefill_block``, which keeps the state its forward
  computed (the sLSTM loop's last state, the scan's last h, mlstm's C in
  one weighted pass) where the JAX one runs ``decode_block`` at every
  position: outputs and states within 1e-5 of the JAX ones; then
  ``decode_block`` (the step form) within 1e-5, outputs and states.
* The whole serve at p in {1, 2}: a prefill of 12 tokens (16 for
  recurrentgemma: two whole rings of its window of 8, as the JAX
  ``attn_local`` prefill misplaces a tail that is not a whole ring), 3
  greedy decode steps, logits within 1e-4 and the greedy tokens equal,
  against the JAX launcher's ``build_serve_step`` at p=1 and the JAX
  ``make_serve_chunk`` stage by stage at p=2.  The JAX launcher's caches
  start at zero, which puts sLSTM's m at 0 where ``cache_spec`` puts it at
  -1e30: the reference here starts from ``cache_init``, and
  ``test_jax_launcher_zero_cache_moves_the_slstm_state`` shows the fault.
* The serving launcher takes both archs on the CPU.
"""

import functools

import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_reduced as jax_get_reduced  # noqa: E402
from repro.core.schedules.ir import Placement as JaxPlacement  # noqa: E402
from repro.launch.mesh import AxisBinding  # noqa: E402
from repro.launch.steps import build_serve_step as jax_build_serve_step  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import modules as jmod  # noqa: E402
from repro.models import serve as jserve  # noqa: E402

from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.launch import serve as launcher  # noqa: E402
from repro_torch.models import modules as tmod  # noqa: E402
from repro_torch.models import serve as tserve  # noqa: E402
from test_torch_recurrent import _params  # noqa: E402
from test_torch_serve_parity import _jax_serve_by_stage  # noqa: E402

BLOCK_TOL = 1e-5
SERVE_TOL = 1e-4
M, B, NEW = 2, 2, 3
PROMPT = {"xlstm_350m": 12, "recurrentgemma_9b": 16}
STATE = {"slstm": {"c": (B, 32), "n": (B, 32), "m": (B, 32)},
         "mlstm": {"C": (B, 2, 16, 16)},
         "rglru": {"h": (B, 48)}}


@pytest.mark.parametrize("kind", ["slstm", "mlstm", "rglru"])
def test_recurrent_serve_blocks_match_jax(kind):
    lcfg, p_j, p_t = _params(kind, seed=2)
    ctx_j, ctx_t = jmod.ShardCtx(), tmod.ShardCtx()
    s, S_ = 19, 24
    cj = jserve.cache_spec(kind, lcfg, ctx_j, B, S_, jnp.float32)
    ct = tserve.cache_spec(kind, lcfg, ctx_t, B, S_, torch.float32, device="cpu", lead=(3,))
    assert {k: tuple(v.shape) for k, v in cj.items()} == STATE[kind]
    assert {k: tuple(v.shape[1:]) for k, v in ct.items()} == STATE[kind]
    assert all(v.dtype == torch.float32 for v in ct.values())
    for k, v in cj.items():
        np.testing.assert_array_equal(ct[k][1].numpy(), np.asarray(v))  # m starts at -1e30
    ct = {k: v[1] for k, v in ct.items()}  # a view, as the executor hands out
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, s, lcfg["d_model"])).astype(np.float32)
    yj, cj = jserve.prefill_block(kind, p_j, jnp.asarray(x), cj, lcfg, ctx_j, jnp.arange(s))
    yt, ct2 = tserve.prefill_block(kind, p_t, torch.from_numpy(x), ct, lcfg, ctx_t,
                                   torch.arange(s))
    assert ct2 is ct  # written in place
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=BLOCK_TOL, atol=BLOCK_TOL)
    for k in cj:
        np.testing.assert_allclose(ct[k].numpy(), np.asarray(cj[k]), rtol=BLOCK_TOL,
                                   atol=BLOCK_TOL, err_msg=k)
    for step in range(2):
        xd = rng.standard_normal((B, 1, lcfg["d_model"])).astype(np.float32)
        yj, cj = jserve.decode_block(kind, p_j, jnp.asarray(xd), cj, s + step, lcfg, ctx_j)
        yt, _ = tserve.decode_block(kind, p_t, torch.from_numpy(xd), ct, s + step, lcfg, ctx_t)
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=BLOCK_TOL, atol=BLOCK_TOL)
        for k in cj:
            np.testing.assert_allclose(ct[k].numpy(), np.asarray(cj[k]), rtol=BLOCK_TOL,
                                       atol=BLOCK_TOL, err_msg=k)


@functools.lru_cache(maxsize=None)
def _jax_launcher_logits(arch, zero_cache=False):
    """The JAX launcher's logits of ``_setup(arch, 1)``'s serve, cached:
    the parity case and the zero-cache case read the same run."""
    cfg_j, _, (st_j, sh_j), _, prompts = _setup(arch, 1)
    return _jax_serve_launcher(cfg_j, st_j, sh_j, prompts, NEW, zero_cache)


def _jax_serve_launcher(cfg, stacked, shared, prompts, new, zero_cache=False):
    """p=1: the JAX launcher's loop over ``build_serve_step``, a cache of
    ``prompt + new`` positions, decode step i at ``cache_len = prompt + i``
    (it decodes at ``cache_len - 1``), the cache from ``cache_init`` (with
    ``zero_cache``, zeros, as ``src/repro/launch/serve.py`` makes it).
    Returns each step's logits."""
    m, b, s = prompts.shape
    mesh = jax.make_mesh((1,), ("data",))
    binding = AxisBinding(pipe="data", tp=None, dp=None)
    placement = JaxPlacement.linear(1)
    out, caches, toks = [], None, None
    for i in range(new + 1):
        mode = "prefill" if i == 0 else "decode"
        spec = jlm.RunSpec(p=1, n_chunks=1, microbatch=b, seq_len=s if i == 0 else 1, m=m)
        make, _, cache_init = jax_build_serve_step(cfg, spec, placement, mesh, binding, mode,
                                                   s + i if i else 0, donate=False)
        if caches is None:
            init = jnp.zeros_like if zero_cache else (lambda a: a)
            caches = [jax.tree_util.tree_map(
                lambda a: jnp.broadcast_to(init(a), (1, m) + a.shape), cache_init(b, s + new))]
        if i == 0:
            side = {"tokens": jnp.asarray(prompts, jnp.int32),
                    "positions": jnp.broadcast_to(jnp.arange(s), (m, s))}
        else:
            side = {"tokens": toks[..., None], "positions": jnp.zeros((m, 1), jnp.int32)}
        logits, caches = make(stacked, shared, side, caches)(stacked, shared, side, caches)
        toks = jnp.argmax(logits, -1).astype(jnp.int32)
        out.append(np.asarray(logits.astype(jnp.float32)))
    return out


def _setup(arch, p):
    cfg_j, cfg_t = jax_get_reduced(arch), get_reduced(arch)
    s = PROMPT[arch]
    spec = jlm.RunSpec(p=p, n_chunks=1, microbatch=B, seq_len=s, m=M)
    stacked_j, shared_j = jlm.init_params(cfg_j, spec, JaxPlacement.linear(p))
    np_tree = jax.tree_util.tree_map(np.asarray, (stacked_j, shared_j))
    stacked_t, shared_t = params_from_numpy(*np_tree, device="cpu")
    prompts = np.random.default_rng(p).integers(0, cfg_t.vocab, (M, B, s))
    return cfg_j, cfg_t, (stacked_j, shared_j), (stacked_t, shared_t), prompts


@pytest.mark.parametrize("p", [1, 2])
@pytest.mark.parametrize("arch", ["xlstm_350m", "recurrentgemma_9b"])
def test_recurrent_serve_matches_jax_f32(arch, p):
    cfg_j, cfg_t, (st_j, sh_j), (st_t, sh_t), prompts = _setup(arch, p)
    if p == 1:
        ref = _jax_launcher_logits(arch)
    else:
        ref = _jax_serve_by_stage(cfg_j, st_j, sh_j, prompts, NEW, p)
    res = launcher.serve(cfg_t, st_t, sh_t, prompts, p=p, new_tokens=NEW)
    assert len(res.logits) == len(ref) == NEW + 1
    for i, (got, want) in enumerate(zip(res.logits, ref)):
        assert tuple(got.shape) == want.shape == (M, B, cfg_t.vocab), i
        np.testing.assert_allclose(got.float().numpy(), want, rtol=SERVE_TOL, atol=SERVE_TOL)
        np.testing.assert_array_equal(res.tokens[..., i].numpy(), want.argmax(-1))


def test_jax_launcher_zero_cache_moves_the_slstm_state():
    """``src/repro/launch/serve.py`` makes the caches with ``jnp.zeros``
    shaped like ``cache_init``'s, so an sLSTM layer's m starts at 0, not
    -1e30: the JAX prefill's decode recurrence then reaches another state
    than its forward (m_0 = max(f_0, i_0), not i_0), and every decode step
    parts from the prefill.  The prefill's own logits do not move (its
    output is the forward's); the decode ones do, by far more than
    rounding, while the port (``cache_spec``'s -1e30) agrees with the right
    start."""
    _, cfg_t, _, (st_t, sh_t), prompts = _setup("xlstm_350m", 1)
    right = _jax_launcher_logits("xlstm_350m")
    zeros = _jax_launcher_logits("xlstm_350m", zero_cache=True)
    res = launcher.serve(cfg_t, st_t, sh_t, prompts, p=1, new_tokens=1)
    np.testing.assert_allclose(zeros[0], right[0], rtol=0, atol=1e-6)
    assert np.abs(zeros[1] - right[1]).max() > 1e-3
    np.testing.assert_allclose(res.logits[1].numpy(), right[1], rtol=SERVE_TOL, atol=SERVE_TOL)


@pytest.mark.parametrize("arch", ["xlstm_350m", "recurrentgemma_9b"])
def test_recurrent_serve_launcher_on_the_cpu(arch, capsys):
    res = launcher.main(["--arch", arch, "--reduced", "--device", "cpu", "--pipe-size", "2",
                         "--groups", "2", "--prompt-len", "12", "--new-tokens", "3"])
    assert capsys.readouterr().out.splitlines()[-1] == "OK"
    assert tuple(res.tokens.shape) == (2, 2, 4)
    assert all(bool(torch.isfinite(lg).all()) for lg in res.logits)
