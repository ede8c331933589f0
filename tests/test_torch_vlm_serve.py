"""Reduced ``llava_next_mistral_7b`` served by the port against the JAX
package, in float32 on the CPU: a prefill of 4 patches and 12 prompt
tokens, then 3 greedy decode steps, the logits within 1e-4 and the greedy
tokens equal.  At p=1 the reference is the JAX launcher's step
(``repro.launch.steps.build_serve_step``) with a correctly sized cache:
``n_patches + prompt + new`` positions, decode step i at ``cache_len =
n_patches + prompt + i + 1``; at p=2 the JAX ``make_serve_chunk`` stage by
stage, at the same positions.

The JAX serve launcher sizes its cache ``prompt + new`` and decodes at
``cache_len = prompt + i + 1`` (``src/repro/launch/serve.py``), which for a
vlm is too short: its prefill keeps the tail of the patches and prompt,
and decode writes over a prompt key at a rope position ``n_patches`` too
small.  ``test_jax_launcher_cache_drops_the_patches`` shows it: that decode
parts from a prefill of the prompt and the first token, while the
correctly sized JAX decode and the port's agree with it.
"""

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
from repro_torch.models.lm import front_spec  # noqa: E402

ARCH = "llava_next_mistral_7b"
SERVE_TOL = 1e-4
M, B, S, NEW = 2, 2, 12, 3


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _front_side(cfg, front):
    """The JAX side input of the front: {key: front} (float32)."""
    key = front_spec(cfg)[0]
    return {key: jnp.asarray(front)}


def jax_serve_launcher(cfg, stacked, shared, prompts, front, new, cache_size, cache_len):
    """p=1: the JAX launcher's loop over ``build_serve_step``, its cache
    ``cache_size`` positions long and decode step i at ``cache_len(i)``
    (the step decodes at ``cache_len - 1``); the prefill positions run over
    the front and the prompt.  Returns each step's logits."""
    m, b, s = prompts.shape
    n = front.shape[2]
    mesh = jax.make_mesh((1,), ("data",))
    binding = AxisBinding(pipe="data", tp=None, dp=None)
    placement = JaxPlacement.linear(1)
    out, caches, toks = [], None, None
    for i in range(new + 1):
        mode = "prefill" if i == 0 else "decode"
        spec = jlm.RunSpec(p=1, n_chunks=1, microbatch=b, seq_len=s if i == 0 else 1, m=m)
        make, _, cache_init = jax_build_serve_step(cfg, spec, placement, mesh, binding, mode,
                                                   cache_len(i - 1) if i else 0, donate=False)
        if caches is None:
            caches = [jax.tree_util.tree_map(lambda a: jnp.zeros((1, m) + a.shape, a.dtype),
                                             cache_init(b, cache_size))]
        if i == 0:
            side = {"tokens": jnp.asarray(prompts, jnp.int32),
                    "positions": jnp.broadcast_to(jnp.arange(n + s), (m, n + s)),
                    **_front_side(cfg, front)}
        else:
            side = {"tokens": toks[..., None], "positions": jnp.zeros((m, 1), jnp.int32)}
        logits, caches = make(stacked, shared, side, caches)(stacked, shared, side, caches)
        toks = jnp.argmax(logits, -1).astype(jnp.int32)
        out.append(np.asarray(logits.astype(jnp.float32)))
    return out


def jax_serve_by_stage(cfg, stacked, shared, prompts, front, new, p, cached):
    """p>1: the JAX ``make_serve_chunk`` applied stage by stage, the
    prefill's input from the JAX ``make_src`` (front and tokens), its cache
    ``cached + prompt + new`` long, decode step i at ``cached + prompt + i``
    (``cached``: the front positions the cache holds)."""
    m, b, s = prompts.shape
    n = front.shape[2]
    spec = jlm.RunSpec(p=p, n_chunks=1, microbatch=b, seq_len=s, m=m)
    pre, cache_init, _ = jserve.make_serve_chunk(cfg, spec, "prefill")
    dec, _, _ = jserve.make_serve_chunk(cfg, spec, "decode")
    pre, dec = jax.jit(pre), jax.jit(dec)
    ctx = jmod.ShardCtx()
    src = jlm.make_src(cfg, ctx)[0]
    params = [jax.tree_util.tree_map(lambda a: a[st], stacked[0]) for st in range(p)]
    caches = [[cache_init(b, cached + s + new) for _ in range(p)] for _ in range(m)]

    def sink(y):
        yn = jmod.rmsnorm(shared["final_ln"], y[:, -1:])
        return (yn @ shared["head"])[:, 0]

    out, toks = [], [None] * m
    for i in range(new + 1):
        step_logits = []
        for j in range(m):
            if i == 0:
                x = src(shared, {"tokens": jnp.asarray(prompts[j]),
                                 **_front_side(cfg, front[j])})
                side = {"positions": jnp.arange(n + s)}
            else:
                x = jlm._embed_lookup(shared, toks[j][:, None], cfg, ctx)
                side = {}
            for st in range(p):
                if i == 0:
                    x, caches[j][st] = pre(params[st], x, side, caches[j][st], 0)
                else:
                    x, caches[j][st] = dec(params[st], x, side, caches[j][st],
                                           cached + s + i - 1)
            lg = sink(x)
            toks[j] = jnp.argmax(lg, -1)
            step_logits.append(np.asarray(lg.astype(jnp.float32)))
        out.append(np.stack(step_logits))
    return out


def setup(arch, p, seed=0):
    cfg_j, cfg_t = jax_get_reduced(arch), get_reduced(arch)
    spec = jlm.RunSpec(p=p, n_chunks=1, microbatch=B, seq_len=S, m=M)
    stacked_j, shared_j = jlm.init_params(cfg_j, spec, JaxPlacement.linear(p))
    stacked_t, shared_t = params_from_numpy(_np(stacked_j), _np(shared_j), device="cpu")
    rng = np.random.default_rng(seed)
    prompts = rng.integers(0, cfg_t.vocab, (M, B, S))
    front = launcher.draw_front(cfg_t, rng, M, B)
    return cfg_j, cfg_t, (stacked_j, shared_j), (stacked_t, shared_t), prompts, front


def check_logits(res, ref, vocab):
    assert len(res.logits) == len(ref) == NEW + 1
    for i, (got, want) in enumerate(zip(res.logits, ref)):
        assert tuple(got.shape) == want.shape == (M, B, vocab), i
        np.testing.assert_allclose(got.float().numpy(), want, rtol=SERVE_TOL, atol=SERVE_TOL)
        np.testing.assert_array_equal(res.tokens[..., i].numpy(), want.argmax(-1))


@pytest.mark.parametrize("p", [1, 2])
def test_vlm_serve_matches_jax_f32(p):
    cfg_j, cfg_t, (st_j, sh_j), (st_t, sh_t), prompts, front = setup(ARCH, p)
    n = cfg_t.extras_dict()["n_patches"]
    assert front.shape == (M, B, n, 16)
    if p == 1:
        ref = jax_serve_launcher(cfg_j, st_j, sh_j, prompts, front, NEW, n + S + NEW,
                                 lambda i: n + S + i + 1)
    else:
        ref = jax_serve_by_stage(cfg_j, st_j, sh_j, prompts, front, NEW, p, cached=n)
    res = launcher.serve(cfg_t, st_t, sh_t, prompts, p=p, new_tokens=NEW, front=front)
    check_logits(res, ref, cfg_t.vocab)


def test_jax_launcher_cache_drops_the_patches():
    """Decode of token P (after a prompt of P) against a prefill of P + 1:
    the JAX launcher's cache (P + new positions, decode at cache_len P + 1)
    parts from it; a correctly sized JAX cache and the port agree."""
    cfg_j, cfg_t, (st_j, sh_j), (st_t, sh_t), prompts, front = setup(ARCH, 1, seed=5)
    n = cfg_t.extras_dict()["n_patches"]
    right = jax_serve_launcher(cfg_j, st_j, sh_j, prompts, front, 1, n + S + 1,
                               lambda i: n + S + i + 1)
    faulty = jax_serve_launcher(cfg_j, st_j, sh_j, prompts, front, 1, S + 1,
                                lambda i: S + i + 1)
    np.testing.assert_allclose(faulty[0], right[0], rtol=SERVE_TOL, atol=SERVE_TOL)  # prefill
    first = right[0].argmax(-1)
    longer = np.concatenate([prompts, first[..., None]], axis=-1)
    ref = jax_serve_launcher(cfg_j, st_j, sh_j, longer, front, 0, n + S + 1, None)[0]
    port = launcher.serve(cfg_t, st_t, sh_t, prompts, p=1, new_tokens=1, front=front)
    np.testing.assert_allclose(right[1], ref, rtol=SERVE_TOL, atol=SERVE_TOL)
    np.testing.assert_allclose(port.logits[1].numpy(), ref, rtol=SERVE_TOL, atol=SERVE_TOL)
    gap = np.abs(faulty[1] - ref).max()
    assert gap > 100 * SERVE_TOL, gap


def test_serve_needs_the_front():
    cfg_j, cfg_t, _, (st_t, sh_t), prompts, front = setup(ARCH, 1)
    with pytest.raises(ValueError, match="front"):
        launcher.serve(cfg_t, st_t, sh_t, prompts, p=1, new_tokens=1)
    with pytest.raises(ValueError, match="front"):
        launcher.serve(cfg_t, st_t, sh_t, prompts, p=1, new_tokens=1, front=front[:1])


def test_vlm_serve_launcher_on_the_cpu(capsys):
    res = launcher.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--pipe-size", "2",
                         "--groups", "2", "--prompt-len", "12", "--new-tokens", "3"])
    assert capsys.readouterr().out.splitlines()[-1] == "OK"
    assert tuple(res.tokens.shape) == (2, 2, 4)
    assert all(bool(torch.isfinite(lg).all()) for lg in res.logits)
