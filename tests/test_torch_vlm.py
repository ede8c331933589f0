"""The vlm front of the port (``llava_next_mistral_7b``) against the JAX
package, in float32 on the CPU, reduced (4 patches of width 16 ahead of
the tokens).

* The config, full and reduced, equals the JAX package's field for field.
* ``make_src``'s forward (``patches @ front_proj`` before the embedded
  tokens) within 1e-5, and its W (the ``front_proj`` and embedding
  gradients of a cotangent ``dx``) against ``jax.grad`` of the JAX source
  within 1e-4; ``front_proj``'s is one ``wgrad_accum`` call of (b n,
  frontend_dim) x (b n, d), in place into the fp32 accumulator.
* The sink drops the patches' positions: the loss equals the JAX sink's,
  and at b = 2 (a strided slice) the kernel's contiguity rule holds.
* ``init_shared`` draws ``front_proj`` after ``head``: the embedding and
  head bits are the dense family's under the same seed.
* ``build_program`` carries ``n_patches + seq_len`` positions between
  stages, ``side_inputs`` gives the patches and positions over them, and
  the planner's channel message counts them as the JAX planner does.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core.planner import HBMPlanner as JaxHBMPlanner  # noqa: E402
from repro.core.schedules.ir import Placement as JaxPlacement  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import modules as jmod  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.core.planner import HBMPlanner  # noqa: E402
from repro_torch.core.schedules.ir import Placement  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models import modules as tmod  # noqa: E402
from test_torch_train_parity import wgrad_calls  # noqa: E402,F401

ARCH = "llava_next_mistral_7b"
FWD_TOL = 1e-5
GRAD_TOL = 1e-4


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _shared(cfg_j, p=1):
    spec = jlm.RunSpec(p=p, n_chunks=1, microbatch=2, seq_len=8, m=1)
    stacked_j, shared_j = jlm.init_params(cfg_j, spec, JaxPlacement.linear(p))
    stacked_t, shared_t = params_from_numpy(_np(stacked_j), _np(shared_j), device="cpu")
    return shared_j, shared_t


def _side(cfg, b=2, s=8, seed=0):
    rng = np.random.default_rng(seed)
    n, width = cfg.extras_dict()["n_patches"], cfg.extras_dict()["frontend_dim"]
    return {"tokens": rng.integers(0, cfg.vocab, (b, s)),
            "labels": rng.integers(0, cfg.vocab, (b, s)),
            "patches": rng.standard_normal((b, n, width)).astype(np.float32)}


def _both(side):
    jside = {k: jnp.asarray(v) for k, v in side.items()}
    tside = {k: torch.from_numpy(v) for k, v in side.items()}
    return jside, tside


@pytest.mark.parametrize("which", ["CONFIG", "reduced"])
def test_vlm_config_matches_jax(which):
    get, jget = ((configs.get_config, jconfigs.get_config) if which == "CONFIG"
                 else (configs.get_reduced, jconfigs.get_reduced))
    assert dataclasses.asdict(get(ARCH)) == dataclasses.asdict(jget(ARCH))
    assert get(ARCH).family == "vlm" and ARCH not in configs.UNPORTED_ARCHS
    assert tlm.front_spec(get(ARCH))[0] == "patches"


def test_full_width_vlm_is_the_published_one():
    cfg = configs.get_config(ARCH)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff, cfg.vocab) == \
        (32, 4096, 32, 8, 14336, 32000)
    assert tlm.front_spec(cfg) == ("patches", 576, 1024)
    from repro_torch.core.planner import state_bytes

    n_params = state_bytes(cfg, 1, 1).params_card / 2  # bf16 but the mask
    assert 7.2e9 < n_params < 7.3e9


@pytest.mark.parametrize("b", [1, 2])
def test_src_fwd_matches_jax(b):
    cfg_j, cfg_t = jconfigs.get_reduced(ARCH), configs.get_reduced(ARCH)
    shared_j, shared_t = _shared(cfg_j)
    jside, tside = _both(_side(cfg_t, b=b))
    want = jlm.make_src(cfg_j, jmod.ShardCtx())[0](shared_j, jside)
    got = tlm.make_src(cfg_t, tmod.ShardCtx())[0](shared_t, tside)
    n = cfg_t.extras_dict()["n_patches"]
    assert tuple(got.shape) == (b, n + 8, cfg_t.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=FWD_TOL, atol=FWD_TOL)


@pytest.mark.parametrize("b", [1, 2])
def test_src_bwd_w_matches_jax_grad(b, wgrad_calls):
    cfg_j, cfg_t = jconfigs.get_reduced(ARCH), configs.get_reduced(ARCH)
    shared_j, shared_t = _shared(cfg_j)
    side = _side(cfg_t, b=b, seed=1)
    jside, tside = _both(side)
    n, width = cfg_t.extras_dict()["n_patches"], cfg_t.extras_dict()["frontend_dim"]
    dx = np.random.default_rng(2).standard_normal((b, n + 8, cfg_t.d_model)).astype(np.float32)
    src_j = jlm.make_src(cfg_j, jmod.ShardCtx())[0]
    want = jax.grad(lambda sh: jnp.sum(src_j(sh, jside) * dx))(shared_j)
    acc = {k: torch.zeros(v.shape, dtype=torch.float32) for k, v in shared_t.items()}
    front = acc["front_proj"]
    got = tlm.make_src(cfg_t, tmod.ShardCtx())[1](shared_t, tside, torch.from_numpy(dx), acc)
    assert got is acc and got["front_proj"] is front  # in place
    for k in ("front_proj", "embed"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=k)
    assert float(got["front_proj"].abs().sum()) > 0
    assert wgrad_calls == [((b * n, width), (b * n, cfg_t.d_model))]
    # and the JAX package's own W of the source
    jw = jlm.make_src(cfg_j, jmod.ShardCtx())[1](shared_j, jside, jnp.asarray(dx))
    np.testing.assert_allclose(got["front_proj"].numpy(), np.asarray(jw["front_proj"]),
                               rtol=GRAD_TOL, atol=GRAD_TOL)


@pytest.mark.parametrize("b", [1, 2])
def test_sink_drops_the_patches(b, monkeypatch):
    cfg_j, cfg_t = jconfigs.get_reduced(ARCH), configs.get_reduced(ARCH)
    shared_j, shared_t = _shared(cfg_j)
    side = _side(cfg_t, b=b, seed=3)
    jside, tside = _both(side)
    n = cfg_t.extras_dict()["n_patches"]
    y = np.random.default_rng(4).standard_normal((b, n + 8, cfg_t.d_model)).astype(np.float32)
    want = jlm.make_sink_fn(cfg_j, jmod.ShardCtx(), 4)(shared_j, jnp.asarray(y), jside)
    normed = []
    real = tmod.ops.rmsnorm

    def contiguous_only(x, g, eps=1e-6):
        assert x.is_contiguous()
        normed.append(tuple(x.shape))
        return real(x, g, eps)

    monkeypatch.setattr(tmod.ops, "rmsnorm", contiguous_only)
    got = tlm.make_sink_fn(cfg_t, tmod.ShardCtx(), 4)(shared_t, torch.from_numpy(y), tside)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=FWD_TOL, atol=FWD_TOL)
    assert normed == [(b, 8, cfg_t.d_model)]
    dense = dataclasses.replace(cfg_t, family="dense")
    tokens_only = torch.from_numpy(np.ascontiguousarray(y[:, n:]))
    plain = tlm.make_sink_fn(dense, tmod.ShardCtx(), 4)(shared_t, tokens_only, tside)
    assert torch.equal(got, plain)


def test_front_proj_is_drawn_after_the_head():
    cfg = configs.get_reduced(ARCH)
    dense = dataclasses.replace(cfg, family="dense", extras=())
    spec = tlm.RunSpec(p=2, n_chunks=1, microbatch=1, seq_len=8, m=1)
    st, sh = tlm.init_params(cfg, spec, Placement.linear(2), seed=0, device="cpu")
    st_d, sh_d = tlm.init_params(dense, spec, Placement.linear(2), seed=0, device="cpu")
    assert sorted(sh) == ["embed", "final_ln", "front_proj", "head"] and sorted(sh_d) == [
        "embed", "final_ln", "head"]
    for k in sh_d:
        assert torch.equal(sh[k], sh_d[k]), k
    assert tuple(sh["front_proj"].shape) == (16, cfg.d_model)
    assert abs(float(sh["front_proj"].std()) - 0.02) < 0.01


def test_program_and_side_inputs_carry_the_patches():
    cfg = configs.get_reduced(ARCH)
    spec = tlm.RunSpec(p=2, n_chunks=1, microbatch=2, seq_len=8, m=3)
    prog = tlm.build_program(cfg, spec, Placement.linear(2))
    assert prog.act_shape == (2, 4 + 8, cfg.d_model)
    side = tlm.side_inputs(cfg, spec)
    assert side["patches"].shape == (3, 2, 4, 16) and side["patches"].dtype == np.float32
    assert side["tokens"].shape == side["labels"].shape == (3, 2, 8)
    np.testing.assert_array_equal(side["positions"], np.broadcast_to(np.arange(12), (3, 12)))


@pytest.mark.parametrize("arch", [ARCH, "whisper_tiny"])
@pytest.mark.parametrize("full", [False, True], ids=["reduced", "full-width"])
def test_channel_message_counts_the_front_as_jax(arch, full):
    get, jget = ((configs.get_config, jconfigs.get_config) if full
                 else (configs.get_reduced, jconfigs.get_reduced))
    kw = dict(p=2, m=4, microbatch=1, seq_len=64)
    mine = HBMPlanner(get(arch), **kw)._act_msg_bytes()
    ref = JaxHBMPlanner(jget(arch), **kw)._act_msg_bytes()
    assert mine == ref == (tlm.front_len(get(arch)) + 64) * get(arch).d_model * (
        2 if full else 4)
