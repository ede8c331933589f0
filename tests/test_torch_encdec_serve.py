"""Reduced ``whisper_tiny`` served by the port against the JAX package, in
float32 on the CPU: a prefill of 8 frames and 12 prompt tokens, then 3
greedy decode steps, the logits within 1e-4 and the greedy tokens equal,
at p=1 (the JAX launcher's ``build_serve_step``, whose cache of ``prompt +
new`` decoder positions and ``cache_len = prompt + i + 1`` are right for
an encdec model: the frames stay out of the decoder's cache) and p=2 (the
JAX ``make_serve_chunk`` stage by stage).

The kind's serve blocks: ``cache_spec`` holds the decoder's k/v and the
encoder stream ``enc`` (b, s_enc, d); ``prefill_block`` fills them as the
JAX one does; ``decode_block`` (causal self-attention over the cache,
cross-attention over ``enc``) within 1e-5 of the JAX one, its caches too.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import modules as jmod  # noqa: E402
from repro.models import serve as jserve  # noqa: E402

from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.launch import serve as launcher  # noqa: E402
from repro_torch.models import modules as tmod  # noqa: E402
from repro_torch.models import serve as tserve  # noqa: E402
from repro_torch.models.lm import RunSpec, layer_cfg  # noqa: E402
from test_torch_encdec import _params  # noqa: E402
from test_torch_vlm_serve import NEW, S, check_logits, jax_serve_by_stage  # noqa: E402
from test_torch_vlm_serve import jax_serve_launcher, setup  # noqa: E402

ARCH = "whisper_tiny"
BLOCK_TOL = 1e-5


@pytest.mark.parametrize("p", [1, 2])
def test_encdec_serve_matches_jax_f32(p):
    cfg_j, cfg_t, (st_j, sh_j), (st_t, sh_t), prompts, front = setup(ARCH, p)
    assert front.shape[2:] == (8, 32)
    if p == 1:
        ref = jax_serve_launcher(cfg_j, st_j, sh_j, prompts, front, NEW, S + NEW,
                                 lambda i: S + i + 1)
    else:
        ref = jax_serve_by_stage(cfg_j, st_j, sh_j, prompts, front, NEW, p, cached=0)
    res = launcher.serve(cfg_t, st_t, sh_t, prompts, p=p, new_tokens=NEW, front=front)
    check_logits(res, ref, cfg_t.vocab)


def test_encdec_prefill_then_decode_block_match_jax():
    lcfg, pj, pt = _params(seed=2)
    b, s_dec, S_ = 2, 12, 16
    s_enc = lcfg["s_enc"]
    ctx_j, ctx_t = jmod.ShardCtx(), tmod.ShardCtx()
    cj = jserve.cache_spec("encdec", lcfg, ctx_j, b, S_, jnp.float32)
    ct = tserve.cache_spec("encdec", lcfg, ctx_t, b, S_, torch.float32, device="cpu")
    assert {k: tuple(v.shape) for k, v in ct.items()} == {k: v.shape for k, v in cj.items()} == {
        "k": (b, S_, 2, 16), "v": (b, S_, 2, 16), "enc": (b, s_enc, 32)}
    rng = np.random.default_rng(3)
    x = rng.standard_normal((b, s_enc + s_dec, lcfg["d_model"])).astype(np.float32)
    pos = np.arange(s_enc + s_dec)
    yj, cj = jserve.prefill_block("encdec", pj, jnp.asarray(x), cj, lcfg, ctx_j, jnp.asarray(pos))
    yt, ct2 = tserve.prefill_block("encdec", pt, torch.from_numpy(x), ct, lcfg, ctx_t,
                                   torch.from_numpy(pos))
    assert ct2 is ct  # in place
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=BLOCK_TOL, atol=BLOCK_TOL)
    for name in cj:
        np.testing.assert_allclose(ct[name].numpy(), np.asarray(cj[name]), rtol=BLOCK_TOL,
                                   atol=BLOCK_TOL, err_msg=name)
    xd = rng.standard_normal((b, 1, lcfg["d_model"])).astype(np.float32)
    yj, cj = jserve.decode_block("encdec", pj, jnp.asarray(xd), cj, s_dec, lcfg, ctx_j)
    yt, _ = tserve.decode_block("encdec", pt, torch.from_numpy(xd), ct, s_dec, lcfg, ctx_t)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=BLOCK_TOL, atol=BLOCK_TOL)
    for name in cj:
        np.testing.assert_allclose(ct[name].numpy(), np.asarray(cj[name]), rtol=BLOCK_TOL,
                                   atol=BLOCK_TOL, err_msg=name)
    assert float(ct["k"][:, s_dec].abs().sum()) > 0 and float(ct["k"][:, s_dec + 1:].abs().sum()) == 0


def test_decode_runs_the_token_alone():
    """A decode step's source is the token's embedding: the frames went in
    with the prompt."""
    cfg = get_reduced(ARCH)
    spec = RunSpec(p=1, n_chunks=1, microbatch=2, seq_len=12, m=1)
    pre, _ = tserve.build_serve_program(cfg, spec, None, "prefill")
    dec, _ = tserve.build_serve_program(cfg, dataclasses.replace(spec, seq_len=1), None, "decode")
    assert pre.act_shape == (2, 8 + 12, cfg.d_model) and dec.act_shape == (2, 1, cfg.d_model)
    shared = {"embed": torch.randn(cfg.vocab, cfg.d_model)}
    tokens = torch.tensor([[3], [5]])
    assert torch.equal(dec.src(shared, {"tokens": tokens}), shared["embed"][tokens])


def test_encdec_serve_launcher_on_the_cpu(capsys):
    res = launcher.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--pipe-size", "2",
                         "--groups", "2", "--prompt-len", "12", "--new-tokens", "3"])
    assert capsys.readouterr().out.splitlines()[-1] == "OK"
    assert tuple(res.tokens.shape) == (2, 2, 4)
    assert all(bool(torch.isfinite(lg).all()) for lg in res.logits)
    assert layer_cfg(get_reduced(ARCH))["s_enc"] == 8


@pytest.mark.parametrize("dec_on", [1.0, 0.5])
def test_jax_decode_ignores_dec_on(dec_on):
    """The JAX ``decode_block`` of the kind runs the decoder layer without
    its ``dec_on`` gate, which ``apply_encdec`` applies: with the role
    scalar at 1 (its init) a decode step equals the last position of a
    prefill one token longer; trained away from 1 the two part.  The port
    decodes as the JAX package does (the same output either way)."""
    lcfg, pj, pt = _params(seed=4)
    pj, pt = dict(pj, dec_on=jnp.float32(dec_on)), dict(pt, dec_on=torch.tensor(dec_on))
    b, s_dec = 2, 6
    s_enc = lcfg["s_enc"]
    ctx_j, ctx_t = jmod.ShardCtx(), tmod.ShardCtx()
    rng = np.random.default_rng(9)
    x = rng.standard_normal((b, s_enc + s_dec + 1, lcfg["d_model"])).astype(np.float32)
    head, last = np.ascontiguousarray(x[:, :-1]), np.ascontiguousarray(x[:, -1:])
    pos = np.arange(s_enc + s_dec + 1)
    longer, _ = jserve.prefill_block("encdec", pj, jnp.asarray(x), jserve.cache_spec(
        "encdec", lcfg, ctx_j, b, s_dec + 1, jnp.float32), lcfg, ctx_j, jnp.asarray(pos))
    cj = jserve.cache_spec("encdec", lcfg, ctx_j, b, s_dec + 1, jnp.float32)
    _, cj = jserve.prefill_block("encdec", pj, jnp.asarray(head), cj, lcfg, ctx_j,
                                 jnp.asarray(pos[:-1]))
    ct = tserve.cache_spec("encdec", lcfg, ctx_t, b, s_dec + 1, torch.float32, device="cpu")
    tserve.prefill_block("encdec", pt, torch.from_numpy(head), ct, lcfg, ctx_t,
                         torch.from_numpy(pos[:-1]))
    yj, _ = jserve.decode_block("encdec", pj, jnp.asarray(last), cj, s_dec, lcfg, ctx_j)
    yt, _ = tserve.decode_block("encdec", pt, torch.from_numpy(last), ct, s_dec, lcfg, ctx_t)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=BLOCK_TOL, atol=BLOCK_TOL)
    gap = float(np.abs(np.asarray(yj) - np.asarray(longer[:, -1:])).max())
    if dec_on == 1.0:
        assert gap < BLOCK_TOL, gap
    else:
        assert gap > 1e-2, gap
