"""The port's recurrent kinds (``slstm``, ``mlstm``, ``rglru``) against the
JAX package, in float32 on the CPU, at ``xlstm_350m``'s and
``recurrentgemma_9b``'s ``reduced()`` widths.

* ``apply_slstm``, ``apply_mlstm`` and ``apply_rglru`` within 1e-5 of the
  JAX functions at b in {1, 2}; mLSTM at its stock chunk of 128 and at a
  chunk of 8 over a sequence that crosses chunk borders (and pads the last
  chunk); RG-LRU under both ``rglru_scan`` forms.
* The B/W split of each recurrent block (with and without its ``mlp``,
  mask 1 and 0) against ``jax.vjp`` of the JAX ``apply_block`` within 1e-4
  (the JAX split of a scan body fails on jax 0.9), B making no weight
  product and W exactly one ``wgrad_accum`` call per product at its shape,
  in forward order; ``lam``'s gradient is finished at B.
* The sLSTM time loop's plain version (``kernels/ref.py::slstm_scan_ref``):
  h, the final state and ``jax.grad`` against the JAX step (the body of
  ``apply_slstm``'s ``lax.scan``, run by ``lax.scan``); the t = 0 tie of
  ``max(n, 1)`` pinned: the gradient of ``i_pre[:, 0]`` is the JAX one, and
  a ``torch.clamp(n, min=1)`` loop, which sends all of it through, differs.
* The leaves: the JAX names and shapes, drawn in the JAX order; ``lam``
  float32 in a bf16 model, kept float32 by ``params_from_numpy``.
* The configs field for field, and the byte model's recurrent pricing
  (6 d a token) against the JAX package's.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core.memory import ActivationByteModel as JaxByteModel  # noqa: E402
from repro.core.schedules.ir import Placement as JaxPlacement  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import modules as jmod  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.core.memory import ActivationByteModel  # noqa: E402
from repro_torch.core.passes import autograd_fbw  # noqa: E402
from repro_torch.core.schedules.ir import Placement  # noqa: E402
from repro_torch.interop import params_from_numpy, to_torch  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.ref import slstm_scan_ref  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models import modules as tmod  # noqa: E402
from repro_torch.tree import tree_flatten, tree_map  # noqa: E402
from test_torch_train_parity import _acc_like, _close, _close_trees  # noqa: E402
from test_torch_train_parity import wgrad_calls  # noqa: E402,F401

FWD_TOL = 1e-5
GRAD_TOL = 1e-4
ARCH_OF = {"slstm": "xlstm_350m", "mlstm": "xlstm_350m", "rglru": "recurrentgemma_9b"}
LEAVES = {"slstm": ("ln", "si", "sf", "sz", "sog", "so"),
          "mlstm": ("ln", "mq", "mk", "mv", "mfg", "mig", "mo"),
          "rglru": ("ln", "rx", "ry", "ra", "ri", "lam", "ro")}


def _lcfg(kind, **extra):
    return dict(tlm.layer_cfg(configs.get_reduced(ARCH_OF[kind])), **extra)


def _params(kind, seed=1, **extra):
    lcfg = _lcfg(kind, **extra)
    p_j = jmod.init_layer(kind, jax.random.PRNGKey(seed), lcfg, jmod.ShardCtx(), jnp.float32)
    return lcfg, p_j, {k: to_torch(np.asarray(v)) for k, v in p_j.items()}


def _x(b, s, d, seed=5):
    return np.random.default_rng(seed).standard_normal((b, s, d)).astype(np.float32)


def _fwd_both(kind, p_j, p_t, x, lcfg, **kw):
    s = x.shape[1]
    if kind == "mlstm":
        yj = jmod.apply_mlstm(p_j, jnp.asarray(x), lcfg, jmod.ShardCtx(), **kw)
        yt = tmod.apply_mlstm(p_t, torch.from_numpy(x), lcfg, tmod.ShardCtx(), **kw)
    else:
        yj = jmod.apply_layer(kind, p_j, jnp.asarray(x), jnp.arange(s), lcfg, jmod.ShardCtx())
        yt = tmod.apply_layer(kind, p_t, torch.from_numpy(x), torch.arange(s), lcfg,
                              tmod.ShardCtx())
    return np.asarray(yj), yt.numpy()


@pytest.mark.parametrize("b", [1, 2])
@pytest.mark.parametrize("kind,s,kw", [
    ("slstm", 19, {}), ("mlstm", 19, {}), ("mlstm", 37, {"chunk": 8}), ("rglru", 19, {})],
    ids=["slstm", "mlstm", "mlstm-chunk8", "rglru"])
def test_apply_matches_jax(kind, s, kw, b):
    lcfg, p_j, p_t = _params(kind)
    yj, yt = _fwd_both(kind, p_j, p_t, _x(b, s, lcfg["d_model"]), lcfg, **kw)
    np.testing.assert_allclose(yt, yj, rtol=FWD_TOL, atol=FWD_TOL)


def test_mlstm_gradient_is_finite_where_the_jax_one_overflows():
    """One full chunk of 128 positions at s = 256: the cumulative log of
    the forget gates spans more than fp32's exp range, so the JAX decay's
    masked half overflows to inf and ``jnp.where`` leaves 0 * inf = NaN in
    the gradient (of ``mfg`` and ``ln`` here; ROADMAP Queue 3).  The port
    masks the exponent: the same forward, a finite gradient, the JAX one
    on every leaf where that is finite."""
    lcfg, p_j, p_t = _params("mlstm", seed=0)
    x = _x(1, 256, lcfg["d_model"], seed=0)
    yj, yt = _fwd_both("mlstm", p_j, p_t, x, lcfg)
    np.testing.assert_allclose(yt, yj, rtol=FWD_TOL, atol=FWD_TOL)
    g_j = jax.grad(lambda p: jnp.sum(jmod.apply_mlstm(p, jnp.asarray(x), lcfg,
                                                      jmod.ShardCtx())))(p_j)
    pt = {k: v.clone().requires_grad_(True) for k, v in p_t.items()}
    tmod.apply_mlstm(pt, torch.from_numpy(x), lcfg, tmod.ShardCtx()).sum().backward()
    nan = {k for k, v in g_j.items() if np.isnan(np.asarray(v)).any()}
    assert nan == {"ln", "mfg"}
    for k, v in pt.items():
        assert bool(torch.isfinite(v.grad).all()), k
        if k not in nan:
            np.testing.assert_allclose(v.grad.numpy(), np.asarray(g_j[k]), rtol=GRAD_TOL,
                                       atol=GRAD_TOL, err_msg=k)


@pytest.mark.parametrize("form", ["associative", "sequential"])
def test_rglru_scan_forms_match_jax(form):
    """Both recurrence forms against the JAX function under the same
    ``rglru_scan``; the log-depth scan equals the loop within fp32
    rounding (37 steps: six levels, the last partial)."""
    lcfg, p_j, p_t = _params("rglru", rglru_scan=form)
    x = _x(2, 37, lcfg["d_model"], seed=8)
    yj, yt = _fwd_both("rglru", p_j, p_t, x, lcfg)
    np.testing.assert_allclose(yt, yj, rtol=FWD_TOL, atol=FWD_TOL)
    rng = np.random.default_rng(2)
    a = torch.from_numpy(rng.uniform(0.5, 1.0, (2, 37, 5)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((2, 37, 5)).astype(np.float32))
    h, loop = torch.zeros(2, 5), []
    for t in range(37):
        h = a[:, t] * h + g[:, t]
        loop.append(h)
    torch.testing.assert_close(tmod.linear_scan(a, g), torch.stack(loop, 1), rtol=1e-5,
                               atol=1e-5)


def _wgrad_shapes(kinds, lcfg, n):
    h, nh = lcfg["d_model"], lcfg["n_heads"]
    d_r = lcfg.get("lru_width") or h
    per = {"slstm": [(h, h)] * 5,
           "mlstm": [(h, h)] * 3 + [(h, nh)] * 2 + [(h, h)],
           "rglru": [(h, d_r), (h, d_r), (d_r, d_r), (d_r, d_r), (d_r, h)],
           "mlp": [(h, lcfg["d_ff"]), (h, lcfg["d_ff"]), (lcfg["d_ff"], h)]}
    return [((n, i), (n, o)) for k in kinds for i, o in per[k]]


@pytest.mark.parametrize("mask", [1.0, 0.0])
@pytest.mark.parametrize("kinds", [("slstm",), ("mlstm",), ("rglru",), ("rglru", "mlp")],
                         ids=["slstm", "mlstm", "rglru", "rglru-mlp"])
def test_recurrent_block_split_matches_jax_vjp(kinds, mask, wgrad_calls):
    lcfg = _lcfg(kinds[0])
    ctx_j, ctx_t = jmod.ShardCtx(), tmod.ShardCtx()
    kp = tuple(jmod.init_layer(k, jax.random.PRNGKey(7 + i), lcfg, ctx_j, jnp.float32)
               for i, k in enumerate(kinds))
    params_j = (jnp.float32(mask), kp)
    params_t = (torch.tensor(mask), tuple({k: to_torch(np.asarray(v)) for k, v in d.items()}
                                          for d in kp))
    b, s = 2, 19
    rng = np.random.default_rng(3)
    x = rng.standard_normal((b, s, lcfg["d_model"])).astype(np.float32)
    dy = rng.standard_normal((b, s, lcfg["d_model"])).astype(np.float32)
    pos = np.arange(s)

    def f_j(params, xx):
        return jmod.apply_block(kinds, params[0], params[1], xx, jnp.asarray(pos), lcfg, ctx_j)

    y_j, vjp = jax.vjp(f_j, params_j, jnp.asarray(x))
    dparams_j, dx_j = vjp(jnp.asarray(dy))
    port = autograd_fbw(lambda p, xx, sd: tmod.apply_block(kinds, p[0], p[1], xx,
                                                           sd["positions"], lcfg, ctx_t))
    side = {"positions": torch.from_numpy(pos)}
    y_t, res = port.fwd(params_t, torch.from_numpy(x), side)
    dx_t, wctx = port.bwd_x(params_t, res, torch.from_numpy(dy), side)
    _close(y_t, y_j, FWD_TOL)
    _close(dx_t, dx_j, GRAD_TOL)
    assert wgrad_calls == []  # B computes no weight product
    acc = _acc_like(params_j, 11)
    w_t = port.bwd_w(params_t, wctx, side, acc=tree_map(lambda a: torch.from_numpy(np.array(a)),
                                                        acc))
    want = jax.tree_util.tree_map(lambda a, g: a + np.asarray(g), acc, dparams_j)
    _close_trees(w_t, want, GRAD_TOL)
    assert wgrad_calls == _wgrad_shapes(kinds, lcfg, b * s)
    if "rglru" in kinds:  # the fp32 gate scale is a cheap leaf, finished at B
        leaves, _ = tree_flatten(params_t)
        k_lam = next(i for i, t in enumerate(leaves) if t is params_t[1][0]["lam"])
        deferred, _, _, cheap, cheap_grads = wctx
        assert k_lam in cheap and k_lam not in deferred
        assert cheap_grads[cheap.index(k_lam)] is not None


# --------------------------------------------------------------------- #
# the sLSTM time loop's plain version
# --------------------------------------------------------------------- #
def _jax_slstm_scan(i_pre, f_pre, z):
    """The scan of ``src/repro/models/modules.py::apply_slstm`` on its fp32
    gate inputs, its step as written there: -> (hs (b, s, h), (c, n, m))."""
    b, s, h = i_pre.shape

    def step(carry, t):
        c, n, m_ = carry
        i_t, f_t, z_t = i_pre[:, t], f_pre[:, t], z[:, t]
        m_new = jnp.maximum(f_t + m_, i_t)
        i_e = jnp.exp(i_t - m_new)
        f_e = jnp.exp(f_t + m_ - m_new)
        c = f_e * c + i_e * z_t
        n = f_e * n + i_e
        return (c, n, m_new), c / jnp.maximum(n, 1.0)

    init = (jnp.zeros((b, h), jnp.float32), jnp.zeros((b, h), jnp.float32),
            jnp.full((b, h), -1e30, jnp.float32))
    last, hs = jax.lax.scan(step, init, jnp.arange(s))
    return hs.transpose(1, 0, 2), last


def _gates(b=2, s=23, h=6, seed=4):
    rng = np.random.default_rng(seed)
    return tuple((rng.standard_normal((b, s, h)) * sc).astype(np.float32)
                 for sc in (1.5, 1.5, 0.8))


def test_slstm_plain_scan_matches_jax_forward_state_and_grad():
    ins = _gates()
    w = np.random.default_rng(9).standard_normal(ins[0].shape).astype(np.float32)
    hs_j, last_j = _jax_slstm_scan(*map(jnp.asarray, ins))
    grads_j = jax.grad(lambda a, b_, c: jnp.sum(_jax_slstm_scan(a, b_, c)[0] * w),
                       argnums=(0, 1, 2))(*map(jnp.asarray, ins))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in ins]
    hs_t, last_t = slstm_scan_ref(*ts)
    np.testing.assert_allclose(hs_t.detach().numpy(), np.asarray(hs_j), rtol=FWD_TOL,
                               atol=FWD_TOL)
    for a, b_ in zip(last_t, last_j):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b_), rtol=FWD_TOL, atol=FWD_TOL)
    (hs_t * torch.from_numpy(w)).sum().backward()
    for t, g in zip(ts, grads_j):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=GRAD_TOL, atol=GRAD_TOL)
    # the CPU dispatch is the plain version, and checks its arguments
    hs_o, _ = ops.slstm_scan(*(torch.from_numpy(a) for a in ins))
    torch.testing.assert_close(hs_o, hs_t.detach(), rtol=0, atol=0)
    with pytest.raises(TypeError, match="float32"):
        ops.slstm_scan(*(torch.from_numpy(a).double() for a in ins))


def _clamp_scan(i_pre, f_pre, z):
    """The loop with ``torch.clamp(n, min=1)`` for ``max(n, 1)``: the same
    values, but all of the gradient goes through at the tie."""
    b, s, h = i_pre.shape
    c, n, m = torch.zeros(b, h), torch.zeros(b, h), torch.full((b, h), -1e30)
    hs = []
    for t in range(s):
        m_new = torch.maximum(f_pre[:, t] + m, i_pre[:, t])
        i_e = torch.exp(i_pre[:, t] - m_new)
        f_e = torch.exp(f_pre[:, t] + m - m_new)
        c, n, m = f_e * c + i_e * z[:, t], f_e * n + i_e, m_new
        hs.append(c / torch.clamp(n, min=1.0))
    return torch.stack(hs, 1)


def test_slstm_t0_tie_is_halved_and_does_not_reach_the_inputs():
    """At t = 0, m = max(f - 1e30, i) = i, so the input gate is exp(0) = 1,
    the forget gate exp(-1e30 - i) = 0 and n = 1 exactly: ``max(n, 1)``
    sits on its tie in every channel.  There ``jnp.maximum`` and the plain
    version's ``torch.maximum`` send half the gradient to n, a clamp all of
    it.  The share does not reach the inputs: n_0's gradient flows on only
    through the input gate exp(i_0 - m_0), whose derivatives through i_0 and
    through m_0 = i_0 cancel, and through the forget gate, which is 0.  So
    the plain loop and a clamp loop give i_pre[:, 0] (and every input) the
    JAX gradient, to rounding; the tie is pinned where it acts, on n."""
    ins = _gates(s=5, seed=6)
    _, (c, n, m) = slstm_scan_ref(*(torch.from_numpy(a[:, :1]) for a in ins))
    assert torch.equal(n, torch.ones_like(n)) and torch.equal(m, torch.from_numpy(ins[0][:, 0]))
    one = torch.ones(())
    n0 = n.clone().requires_grad_(True)
    assert float(jax.grad(lambda v: jnp.maximum(v, 1.0))(1.0)) == 0.5
    assert torch.autograd.grad(torch.maximum(n0, one).sum(), n0)[0].unique().tolist() == [0.5]
    assert torch.autograd.grad(torch.clamp(n0, min=1.0).sum(), n0)[0].unique().tolist() == [1.0]
    w = np.random.default_rng(1).standard_normal(ins[0].shape).astype(np.float32)
    g_j = jax.grad(lambda *a: jnp.sum(_jax_slstm_scan(*a)[0] * w), argnums=(0, 1, 2))(
        *map(jnp.asarray, ins))
    for fn in (lambda *a: slstm_scan_ref(*a)[0], _clamp_scan):
        ts = [torch.from_numpy(a).requires_grad_(True) for a in ins]
        (fn(*ts) * torch.from_numpy(w)).sum().backward()
        for t, g in zip(ts, g_j):
            np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=1e-6, atol=1e-6)
    assert not np.asarray(g_j[1])[:, 0].any()  # f_pre[:, 0]: its gate is 0


# --------------------------------------------------------------------- #
# leaves, carry-over, configs
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("kind", ["slstm", "mlstm", "rglru"])
def test_leaves_match_jax_in_draw_order(kind):
    lcfg = _lcfg(kind)
    p_j = jmod.init_layer(kind, jax.random.PRNGKey(0), lcfg, jmod.ShardCtx(), jnp.float32)
    gen = torch.Generator().manual_seed(0)
    p_t = tmod.init_layer(kind, gen, lcfg, tmod.ShardCtx(), torch.float32)
    assert tuple(p_t) == LEAVES[kind] and sorted(p_j) == sorted(LEAVES[kind])
    assert {k: tuple(v.shape) for k, v in p_t.items()} == \
        {k: tuple(np.shape(v)) for k, v in p_j.items()}
    assert not p_t["ln"].any()
    if kind == "rglru":
        assert torch.equal(p_t["lam"], torch.full_like(p_t["lam"], 2.0))
    drawn = [k for k in LEAVES[kind] if k not in ("ln", "lam")]
    gen = torch.Generator().manual_seed(0)
    sizes = [p_t[k].numel() for k in drawn]
    stream = torch.randn(sum(sizes), generator=gen)
    for k, a, n in zip(drawn, np.cumsum([0] + sizes[:-1]), sizes):
        ratio = p_t[k].reshape(-1) / stream[a:a + n]
        torch.testing.assert_close(ratio, torch.full_like(ratio, float(ratio[0])))


def test_lam_stays_float32_in_a_bf16_model():
    """``init_rglru`` keeps ``lam`` float32 in a bf16 model, in both
    packages, and ``params_from_numpy(..., dtype=bfloat16)`` carries it
    over as float32."""
    cfg_j = dataclasses.replace(jconfigs.get_reduced("recurrentgemma_9b"), dtype="bfloat16")
    spec = jlm.RunSpec(p=1, n_chunks=1, microbatch=1, seq_len=8, m=1)
    stacked_j, shared_j = jlm.init_params(cfg_j, spec, JaxPlacement.linear(1))
    np_tree = jax.tree_util.tree_map(np.asarray, (stacked_j, shared_j))
    stacked_t, _ = params_from_numpy(*np_tree, device="cpu", dtype=torch.bfloat16)
    rg, mlp = stacked_t[0]["blocks"][0]
    assert rg["lam"].dtype == torch.float32 and rg["ra"].dtype == torch.bfloat16
    np.testing.assert_array_equal(rg["lam"].numpy(), np_tree[0][0]["blocks"][0][0]["lam"])
    cfg_t = dataclasses.replace(configs.get_reduced("recurrentgemma_9b"), dtype="bfloat16")
    own, _ = tlm.init_params(cfg_t, tlm.RunSpec(p=1, n_chunks=1, microbatch=1, seq_len=8, m=1),
                             Placement.linear(1), device="cpu")
    assert own[0]["blocks"][0][0]["lam"].dtype == torch.float32


@pytest.mark.parametrize("arch", ["xlstm_350m", "recurrentgemma_9b"])
def test_recurrent_configs_and_byte_model_match_jax(arch):
    for get_t, get_j in ((configs.get_config, jconfigs.get_config),
                         (configs.get_reduced, jconfigs.get_reduced)):
        t, j = get_t(arch), get_j(arch)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        for p, nc in ((1, 1), (2, 1), (3, 2)):
            bt = ActivationByteModel.from_config(t, p=p, n_chunks=nc, microbatch=1, seq_len=64)
            bj = JaxByteModel.from_config(j, p=p, n_chunks=nc, microbatch=1, seq_len=64)
            assert (bt.m_b_bytes, bt.m_w_bytes) == (bj.m_b_bytes, bj.m_w_bytes)
    assert arch in configs.ARCH_IDS and not configs.UNPORTED_ARCHS
    assert configs.ARCH_IDS == jconfigs.ARCH_IDS
