"""The port's ``moe`` kind (``repro_torch.models.modules``) against the JAX
package's, in float32 on the CPU, inputs made with numpy from a seed.

* ``_moe_route``: ``top_i`` and the slot positions ``pos_nk`` identical,
  ``top_g`` within 1e-6; the smallest gap between the k-th and the
  (k+1)-th gate is printed (a gap of 0 would make the order a tie-break);
  with every gate equal the order is the JAX ``lax.top_k``'s, lower
  expert first.
* ``apply_moe`` forward and every gradient (x and every leaf, the router
  included) against ``jax.value_and_grad`` under both dispatches, within
  1e-5 relative: at the default capacity, at a capacity that drops
  selections, and with a ``capacity`` override; and the port's scatter
  dispatch against its einsum oracle (the counterpart of
  ``tests/test_arch_smoke.py::test_moe_scatter_matches_einsum_dispatch``).
* The B/W split of the kind (``autograd_fbw`` on ``test_split_blocks.py``'s
  ``KIND_CFG["moe"]``): after B only the norm gain has a gradient, no
  expert, shared-expert or router leaf; W gives ``jax.vjp``'s gradients
  within 2e-5, adding the expert stacks by ``torch.bmm`` in place and the
  router and shared experts through ``wgrad_accum``.
* The dispatch's and combine's hand-written backwards equal autograd of
  plain indexing, and a moe training walk reads nothing back to the host
  and runs no accumulating index_put (no atomics on the card).
* ``params_from_numpy(..., dtype=torch.bfloat16)`` keeps the router, a
  float32 leaf of the JAX tree, in float32, and casts the rest.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_reduced as jax_get_reduced  # noqa: E402
from repro.core.passes import auto_fbw  # noqa: E402
from repro.core.schedules.ir import Placement as JaxPlacement  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import modules as jmod  # noqa: E402

from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.core.executor import PipelineExecutor  # noqa: E402
from repro_torch.core.passes import autograd_fbw  # noqa: E402
from repro_torch.core.schedules import compile_plan, zb_h1  # noqa: E402
from repro_torch.interop import params_from_numpy, to_torch  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models import modules as tmod  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402
from test_split_blocks import KIND_CFG  # noqa: E402
from test_torch_executor_modes import HOST_READS, _RecordOps  # noqa: E402
from test_torch_train_parity import wgrad_calls  # noqa: E402,F401

ARCH = "qwen2_moe_a2_7b"
ROUTE_G_TOL = 1e-6
MOE_RTOL = 1e-5
SPLIT_TOL = 2e-5
# tests/test_arch_smoke.py's config of its scatter-vs-einsum check
SMOKE_CFG = dict(d_model=32, n_heads=4, n_kv_heads=4, d_ff=0, n_layers=2, head_dim=None,
                 tp_size=1, moe_d_ff=16, n_experts=8, topk=2, n_shared_experts=1,
                 capacity_factor=1.5)


def _reduced_cfg(**extra):
    return dict(tlm.layer_cfg(get_reduced(ARCH)), **extra)


# (name, layer cfg, tokens b x s): the reduced model's (no drops at b*s = 32),
# a capacity factor that drops selections, a capacity override, the smoke
# config, and the split test's
CASES = {
    "reduced": (_reduced_cfg(), (2, 16)),
    "drops": (_reduced_cfg(capacity_factor=0.5), (2, 16)),
    "override": (_reduced_cfg(capacity=5), (2, 16)),
    "smoke": (SMOKE_CFG, (2, 12)),
    "split": (KIND_CFG["moe"], (2, 8)),
}


def _params(cfg, seed=0):
    p_j = jmod.init_moe(jax.random.PRNGKey(seed), cfg, jnp.float32)
    return p_j, {k: to_torch(np.asarray(v)) for k, v in p_j.items()}


def _x(cfg, bs, seed=1):
    return np.random.default_rng(seed).standard_normal(bs + (cfg["d_model"],)).astype(np.float32)


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol, err_msg=what)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_route_matches_jax(case, seed):
    cfg, (b, s) = CASES[case]
    p_j, p_t = _params(cfg, seed)
    tok = _x(cfg, (b * s,), seed + 10)
    g_j, i_j, pos_j, oh_j = jmod._moe_route(p_j, jnp.asarray(tok), cfg)
    g_t, i_t, pos_t, oh_t = tmod._moe_route(p_t, torch.from_numpy(tok), cfg)
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    np.testing.assert_array_equal(pos_t.numpy(), np.asarray(pos_j).astype(np.int64))
    np.testing.assert_array_equal(oh_t.numpy(), np.asarray(oh_j))
    _close(g_t, g_j, ROUTE_G_TOL)
    gates = np.asarray(jax.nn.softmax(jnp.asarray(tok) @ p_j["router"], axis=-1))
    srt = -np.sort(-gates, axis=-1)
    k = cfg["topk"]
    gap = float(np.min(srt[:, k - 1] - srt[:, k]))
    print(f"{case} seed {seed}: smallest gap between gate k and k+1: {gap:.3e}")
    assert gap > 0


def test_route_breaks_ties_to_the_lower_expert():
    cfg, (b, s) = CASES["reduced"]
    p_j, p_t = _params(cfg)
    p_j = dict(p_j, router=jnp.zeros_like(p_j["router"]))
    p_t = dict(p_t, router=torch.zeros_like(p_t["router"]))
    tok = _x(cfg, (b * s,))
    _, i_j, pos_j, _ = jmod._moe_route(p_j, jnp.asarray(tok), cfg)
    _, i_t, pos_t, _ = tmod._moe_route(p_t, torch.from_numpy(tok), cfg)
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    np.testing.assert_array_equal(pos_t.numpy(), np.asarray(pos_j).astype(np.int64))
    assert (i_t == torch.arange(cfg["topk"])).all()
    assert (pos_t == torch.arange(b * s)[:, None]).all()  # each expert's n-th selection


def _value_and_grad_both(cfg, bs, dispatch, seed=0):
    """sum(apply_moe(p, x)^2 * r) and its gradients in both packages (r a
    fixed random weighting, so no two gradients are alike)."""
    cfg = dict(cfg, moe_dispatch=dispatch)
    p_j, p_t = _params(cfg, seed)
    x = _x(cfg, bs, seed + 1)
    r = _x(cfg, bs, seed + 2)

    def f_j(p, xx):
        return jnp.sum(jmod.apply_moe(p, xx, cfg, jmod.ShardCtx()) ** 2 * r)

    v_j, (gp_j, gx_j) = jax.value_and_grad(f_j, argnums=(0, 1))(p_j, jnp.asarray(x))
    leaves = {k: v.clone().requires_grad_(True) for k, v in p_t.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    v_t = torch.sum(tmod.apply_moe(leaves, xt, cfg, tmod.ShardCtx()) ** 2 * torch.from_numpy(r))
    v_t.backward()
    return (v_j, gp_j, gx_j), (v_t, {k: t.grad for k, t in leaves.items()}, xt.grad)


@pytest.mark.parametrize("case", ["reduced", "drops", "override", "smoke"])
@pytest.mark.parametrize("dispatch", ["scatter", "einsum"])
def test_apply_moe_value_and_grads_match_jax(case, dispatch):
    cfg, bs = CASES[case]
    (v_j, gp_j, gx_j), (v_t, gp_t, gx_t) = _value_and_grad_both(cfg, bs, dispatch)
    np.testing.assert_allclose(float(v_t.detach()), float(v_j), rtol=MOE_RTOL)
    scale = lambda a: max(1.0, float(np.max(np.abs(np.asarray(a)))))  # noqa: E731
    _close(gx_t / scale(gx_j), np.asarray(gx_j) / scale(gx_j), MOE_RTOL, "x")
    assert sorted(gp_t) == sorted(gp_j)
    for k in gp_j:
        assert gp_t[k].shape == gp_j[k].shape, k
        _close(gp_t[k] / scale(gp_j[k]), np.asarray(gp_j[k]) / scale(gp_j[k]), MOE_RTOL, k)
    n = bs[0] * bs[1]
    cap = tmod.moe_capacity(dict(cfg), n)
    if case == "override":
        assert cap == 5
    if case == "drops":  # the capacity drops selections, and they get no gradient
        assert cfg["topk"] * n > cfg["n_experts"] * cap


def test_drop_case_drops():
    """The "drops" case keeps only part of the selections; "reduced" all."""
    cfg, bs = CASES["drops"]
    p_j, p_t = _params(cfg)
    n = bs[0] * bs[1]
    tok = torch.from_numpy(_x(cfg, (n,), 1))
    _, _, pos, _ = tmod._moe_route(p_t, tok, cfg)
    assert 0 < float((pos >= tmod.moe_capacity(cfg, n)).float().mean()) < 0.6
    cfg_r, _ = CASES["reduced"]
    _, _, pos, _ = tmod._moe_route(p_t, tok, cfg_r)
    assert int(pos.max()) < tmod.moe_capacity(cfg_r, n)


@pytest.mark.parametrize("case", ["smoke", "drops"])
def test_scatter_matches_einsum_dispatch(case):
    """The port's two dispatches: values within 1e-5, gradients within
    2e-4 / 2e-5 (the JAX test's tolerances)."""
    cfg, bs = CASES[case]
    _, (v1, g1, gx1) = _value_and_grad_both(cfg, bs, "einsum")
    _, (v2, g2, gx2) = _value_and_grad_both(cfg, bs, "scatter")
    np.testing.assert_allclose(float(v1.detach()), float(v2.detach()), rtol=1e-5)
    np.testing.assert_allclose(gx1.numpy(), gx2.numpy(), rtol=2e-4, atol=2e-5)
    for k in g1:
        np.testing.assert_allclose(g1[k].numpy(), g2[k].numpy(), rtol=2e-4, atol=2e-5,
                                   err_msg=k)


# --------------------------------------------------------------------- #
# the B/W split of the kind
# --------------------------------------------------------------------- #
DEFERRED = ("router", "wu", "wg", "wd", "swu", "swg", "swd")


def test_split_leaves_every_expert_gradient_to_w(wgrad_calls):
    cfg, (b, s) = CASES["split"]
    p_j, p_t = _params(cfg)
    x = _x(cfg, (b, s), 1) * 0.5
    dy = _x(cfg, (b, s), 2) * 0.5
    pos = np.arange(s)

    def f_j(p, xx, sd):
        return jmod.apply_layer("moe", p, xx, sd["positions"], cfg, jmod.ShardCtx())

    mod_t = autograd_fbw(lambda p, xx, sd: tmod.apply_layer("moe", p, xx, sd["positions"], cfg,
                                                           tmod.ShardCtx()), name="moe")
    side_t = {"positions": torch.from_numpy(pos)}
    y_t, res = mod_t.fwd(p_t, torch.from_numpy(x), side_t)
    dx_t, wctx = mod_t.bwd_x(p_t, res, torch.from_numpy(dy), side_t)
    deferred, batched, pairs, cheap, cheap_grads = wctx
    names = sorted(p_t)
    assert sorted(names[k] for k in deferred) == sorted(DEFERRED)
    assert [names[k] for k in cheap] == ["ln"] and cheap_grads[0] is not None
    assert sorted(names[k] for k, e in zip(deferred, batched) if e) == ["wd", "wg", "wu"]
    for (a, g), k, e in zip(pairs, deferred, batched):
        assert a.dim() == g.dim() == (3 if e else 2), names[k]
    assert wgrad_calls == []  # B computes no weight product

    y_j = f_j(p_j, jnp.asarray(x), {"positions": jnp.asarray(pos)})
    g_j, dx_j = jax.vjp(lambda p, xx: f_j(p, xx, {"positions": jnp.asarray(pos)}), p_j,
                        jnp.asarray(x))[1](jnp.asarray(dy))
    _close(y_t, y_j, SPLIT_TOL)
    _close(dx_t, dx_j, SPLIT_TOL)
    acc = {k: torch.zeros(v.shape, dtype=torch.float32) for k, v in p_t.items()}
    ptrs = {k: acc[k].data_ptr() for k in ("wu", "wg", "wd")}
    g_t = mod_t.bwd_w(p_t, wctx, side_t, acc=acc)
    assert len(wgrad_calls) == 4  # router, swu, swg, swd
    for k in ptrs:  # the expert stacks are added in place
        assert g_t[k] is acc[k] and g_t[k].data_ptr() == ptrs[k]
    for k in names:
        _close(g_t[k], g_j[k], SPLIT_TOL, k)
    # and the split of the JAX package agrees with its own vjp on this case
    mod_j = auto_fbw(f_j, name="moe")
    side_j = {"positions": jnp.asarray(pos)}
    _, res_j = mod_j.fwd(p_j, jnp.asarray(x), side_j)
    _, wctx_j = mod_j.bwd_x(p_j, res_j, jnp.asarray(dy), side_j)
    w_j = mod_j.bwd_w(p_j, wctx_j, side_j)
    for k in names:
        _close(g_t[k], w_j[k], SPLIT_TOL, k)


# --------------------------------------------------------------------- #
# the hand-written backwards; no host read, no atomics in a walk
# --------------------------------------------------------------------- #
def test_dispatch_and_combine_backwards_equal_plain_indexing():
    cfg, (b, s) = CASES["drops"]
    _, p_t = _params(cfg)
    n, k, h = b * s, cfg["topk"], cfg["d_model"]
    tok = torch.from_numpy(_x(cfg, (n,), 1))
    _, top_i, pos, _ = tmod._moe_route(p_t, tok, cfg)
    cap, e = tmod.moe_capacity(cfg, n), cfg["n_experts"]
    keep = pos < cap
    flat = torch.where(keep, top_i * cap + pos, torch.full_like(pos, e * cap))
    sel = torch.full((e * cap + 1,), n * k, dtype=torch.long)
    sel.scatter_(0, flat.reshape(-1), torch.arange(n * k))
    sel = sel[:-1]
    rng = np.random.default_rng(4)
    t1 = tok.clone().requires_grad_(True)
    t2 = tok.clone().requires_grad_(True)
    xe1 = tmod._Dispatch.apply(t1, sel // k, flat)
    xe2 = torch.cat([t2, torch.zeros(1, h)])[sel // k]
    assert torch.equal(xe1, xe2)
    d = torch.from_numpy(rng.standard_normal(xe1.shape).astype(np.float32))
    xe1.backward(d)
    xe2.backward(d)
    torch.testing.assert_close(t1.grad, t2.grad, rtol=1e-6, atol=1e-6)
    o1 = torch.from_numpy(rng.standard_normal((e * cap, h)).astype(np.float32))
    o2 = o1.clone().requires_grad_(True)
    o1.requires_grad_(True)
    pk1 = tmod._Combine.apply(o1, flat, sel)
    pk2 = torch.cat([o2, torch.zeros(1, h)])[flat]
    assert torch.equal(pk1, pk2)
    d = torch.from_numpy(rng.standard_normal(pk1.shape).astype(np.float32))
    pk1.backward(d)
    pk2.backward(d)
    assert torch.equal(o1.grad, o2.grad)


def test_moe_walk_reads_nothing_back_and_adds_no_atomics():
    cfg = get_reduced(ARCH)
    p, m = 2, 2
    sched = zb_h1(p, m)
    spec = tlm.RunSpec(p=p, n_chunks=1, microbatch=2, seq_len=16, m=m)
    stacked, shared = tlm.init_params(cfg, spec, sched.placement, seed=0, device="cpu")
    side = {k: torch.as_tensor(v, dtype=torch.long)
            for k, v in tlm.side_inputs(cfg, spec, seed=1).items()}
    grad_fn = PipelineExecutor(tlm.build_program(cfg, spec, sched.placement),
                               compile_plan(sched)).build_grad_fn()
    with _RecordOps() as rec:
        grads, _, loss = grad_fn(stacked, shared, side)
    names = {n for n, _, _ in rec.ops}
    assert {"bmm", "sort", "cumsum", "scatter_"} <= names, sorted(names)
    assert not names & HOST_READS, sorted(names & HOST_READS)
    accumulating = [n for n, args, kw in rec.ops
                    if n in ("index_put", "index_put_", "_index_put_impl_")
                    and (kw.get("accumulate") or (len(args) > 3 and args[3]))]
    assert not accumulating
    # the only index_add_ is the embedding's
    assert all(args[0].shape[0] == shared["embed"].shape[0]
               for n, args, _ in rec.ops if n == "index_add_")
    assert np.isfinite(float(loss))
    assert grads[0]["blocks"][0][1]["router"].dtype == torch.float32


# --------------------------------------------------------------------- #
# interop: a float32 leaf of a bf16 tree stays float32
# --------------------------------------------------------------------- #
def test_params_from_numpy_keeps_the_router_float32():
    cfg = dataclasses.replace(jax_get_reduced(ARCH), dtype="bfloat16")
    spec = jlm.RunSpec(p=2, n_chunks=1, microbatch=1, seq_len=8, m=1)
    stacked_j, shared_j = jlm.init_params(cfg, spec, JaxPlacement.linear(2))
    np_tree = jax.tree_util.tree_map(np.asarray, (stacked_j, shared_j))
    moe_j = np_tree[0][0]["blocks"][0][1]
    assert moe_j["router"].dtype == np.float32 and moe_j["wu"].dtype.name == "bfloat16"
    # a float32 JAX model cast to bf16 on the way in: all but the float32 leaves
    f32 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), np_tree)
    for tree in (np_tree, f32):
        stacked_t, shared_t = params_from_numpy(*tree, device="cpu", dtype=torch.bfloat16)
        moe_t = stacked_t[0]["blocks"][0][1]
        assert moe_t["router"].dtype == torch.float32
        assert stacked_t[0]["mask"].dtype == torch.float32
        np.testing.assert_array_equal(moe_t["router"].numpy(), moe_j["router"])
    stacked_t, shared_t = params_from_numpy(*np_tree, device="cpu", dtype=torch.bfloat16)
    moe_t = stacked_t[0]["blocks"][0][1]
    for k in ("ln", "wu", "wg", "wd", "swu", "swg", "swd"):
        assert moe_t[k].dtype == torch.bfloat16, k
        np.testing.assert_array_equal(moe_t[k].view(torch.int16).numpy(),
                                      moe_j[k].view(np.int16), err_msg=k)
    assert shared_t["embed"].dtype == torch.bfloat16
    # the port's own init draws the router in float32 too
    st, _ = tlm.init_params(get_reduced(ARCH).__class__(**{
        **dataclasses.asdict(get_reduced(ARCH)), "dtype": "bfloat16"}), tlm.RunSpec(
        p=1, n_chunks=1, microbatch=1, seq_len=8, m=1), JaxPlacement.linear(1), device="cpu")
    assert st[0]["blocks"][0][1]["router"].dtype == torch.float32
    assert st[0]["blocks"][0][1]["wu"].dtype == torch.bfloat16
    assert tree_leaves(st)
