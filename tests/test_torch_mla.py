"""The port's ``mla`` kind (DeepSeek-V3's latent attention) against the JAX
package, in float32 on the CPU, on ``deepseek_v3_671b``'s ``reduced()``
widths (d 64, 4 heads of 16, q rank 32, kv rank 16, rope key 8).

* ``apply_mla`` against ``src/repro/models/modules.py::apply_mla`` within
  1e-5, on the dense attention path (s = 16) and the query-block path
  (s = 2100 > 2 x 1024): qk 24 wide against v 16, the scale 1/sqrt(24).
* The block's F/B/W split against the JAX ``auto_fbw`` within 1e-5 (with
  and without a following ``moe``), W adding all six MLA products
  (``xin@wdq``, ``@wuq``, ``xin@wdkv``, ``c@wuk``, ``c@wuv``, ``o@wo``)
  through ``wgrad_accum`` and B none.
* The leaves: the JAX ``init_mla``'s names and shapes; drawn by the port in
  the order ln, wdq, wuq, wdkv, wuk, wuv, wo; carried over by
  ``params_from_numpy`` with the float32 moe router kept float32 in a bf16
  carry-over.
* The init: the stage-stacked leaves filled in place equal the per-stage
  trees of ``init_chunk_params`` stacked (the earlier init) bit for bit for
  internlm2, gpt3-1.5b and qwen2-moe, reduced, on both placements; no
  block leaf of any full-width config ported before deepseek_v3_671b
  reaches the sliced draw's threshold, so their seed-0 weights keep the
  bits of one whole draw; a leaf past it is drawn in slices and filled.
* The config: ``get_config("deepseek_v3_671b")`` loads the published one;
  ``fixed_state_bytes`` and the activation byte model (the mla kind's
  pricing) equal the JAX package's on the reduced and full configs.
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
from repro.core.passes import auto_fbw  # noqa: E402
from repro.core.planner import fixed_state_bytes as jax_fixed_state_bytes  # noqa: E402
from repro.core.schedules.ir import Placement as JaxPlacement  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import modules as jmod  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.core.memory import ActivationByteModel  # noqa: E402
from repro_torch.core.passes import autograd_fbw  # noqa: E402
from repro_torch.core.planner import fixed_state_bytes  # noqa: E402
from repro_torch.core.schedules.ir import Placement  # noqa: E402
from repro_torch.interop import params_from_numpy, to_torch  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models import modules as tmod  # noqa: E402
from repro_torch.tree import keyed_leaves, tree_leaves, tree_map  # noqa: E402
from test_torch_train_parity import _acc_like, _close, _close_trees, _split_both  # noqa: E402
from test_torch_train_parity import wgrad_calls  # noqa: E402,F401

ARCH = "deepseek_v3_671b"
BLOCK_TOL = 1e-5
MLA_LEAVES = ("ln", "wdq", "wuq", "wdkv", "wuk", "wuv", "wo")


def _lcfg():
    return tlm.layer_cfg(configs.get_reduced(ARCH))


def _params(seed=3):
    lcfg = _lcfg()
    p_j = jmod.init_mla(jax.random.PRNGKey(seed), lcfg, jnp.float32)
    return lcfg, p_j, {k: to_torch(np.asarray(v)) for k, v in p_j.items()}


@pytest.mark.parametrize("s", [16, 2100], ids=["dense", "chunked"])
def test_apply_mla_matches_jax(s):
    lcfg, p_j, p_t = _params()
    b = 1 if s > 2048 else 2
    x = np.random.default_rng(5).standard_normal((b, s, lcfg["d_model"])).astype(np.float32)
    pos = np.arange(s)
    yj = jmod.apply_mla(p_j, jnp.asarray(x), jnp.asarray(pos), lcfg, jmod.ShardCtx())
    yt, c, kr = tmod.mla_forward(p_t, torch.from_numpy(x), torch.from_numpy(pos), lcfg,
                                 tmod.ShardCtx())
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=BLOCK_TOL, atol=BLOCK_TOL)
    assert tuple(c.shape) == (b, s, lcfg["kv_lora_rank"])
    assert tuple(kr.shape) == (b, s, lcfg["qk_rope_head_dim"])
    np.testing.assert_array_equal(
        yt.numpy(), tmod.apply_layer("mla", p_t, torch.from_numpy(x), torch.from_numpy(pos),
                                     lcfg, tmod.ShardCtx()).numpy())


def test_mla_attention_scale_is_the_qk_width():
    """q is head_dim + rope wide, v head_dim: the port's attention takes the
    scale from q, 1/sqrt(24) here, and returns v's width."""
    rng = np.random.default_rng(0)
    q, k = (torch.from_numpy(rng.standard_normal((1, 5, 2, 24)).astype(np.float32))
            for _ in range(2))
    v = torch.from_numpy(rng.standard_normal((1, 5, 2, 16)).astype(np.float32))
    got = tmod.attention(q, k, v)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(24)
    logits = logits.masked_fill(~torch.tril(torch.ones(5, 5, dtype=torch.bool)), -1e30)
    want = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(logits, -1), v)
    assert tuple(got.shape) == (1, 5, 2, 16)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("kinds", [("mla",), ("mla", "moe")])
@pytest.mark.parametrize("mask", [1.0, 0.0])
def test_mla_block_split_matches_jax(kinds, mask, wgrad_calls):
    lcfg = _lcfg()
    ctx_j, ctx_t = jmod.ShardCtx(), tmod.ShardCtx()
    kp = tuple(jmod.init_layer(k, jax.random.PRNGKey(7 + i), lcfg, ctx_j, jnp.float32)
               for i, k in enumerate(kinds))
    params_j = (jnp.float32(mask), kp)
    params_t = (torch.tensor(mask), tuple({k: to_torch(np.asarray(v)) for k, v in d.items()}
                                          for d in kp))
    rng = np.random.default_rng(3)
    b, s = 2, 16
    x = rng.standard_normal((b, s, lcfg["d_model"])).astype(np.float32)
    dy = rng.standard_normal((b, s, lcfg["d_model"])).astype(np.float32)
    pos = np.arange(s)
    jax_mod = auto_fbw(lambda p, xx, sd: jmod.apply_block(kinds, p[0], p[1], xx, sd["positions"],
                                                           lcfg, ctx_j))
    port_mod = autograd_fbw(lambda p, xx, sd: tmod.apply_block(kinds, p[0], p[1], xx,
                                                               sd["positions"], lcfg, ctx_t))
    acc = _acc_like(params_j, 11)
    side_t = {"positions": torch.from_numpy(pos)}
    (y_j, dx_j, w_j), (y_t, dx_t, wctx_t) = _split_both(
        jax_mod, port_mod, params_j, params_t, x, dy, {"positions": jnp.asarray(pos)}, side_t,
        acc)
    _close(y_t, y_j, BLOCK_TOL)
    _close(dx_t, dx_j, BLOCK_TOL)
    assert wgrad_calls == []  # B computes no weight product
    w_t = port_mod.bwd_w(params_t, wctx_t, side_t,
                         acc=tree_map(lambda a: torch.from_numpy(np.array(a)), acc))
    _close_trees(w_t, w_j, BLOCK_TOL)
    # W adds the six MLA products first, in their forward order (then
    # moe's router and 3 shared experts)
    n = b * s
    h, hq, dh = lcfg["d_model"], lcfg["n_heads"], lcfg["head_dim"]
    d_q, d_kv, d_r = lcfg["q_lora_rank"], lcfg["kv_lora_rank"], lcfg["qk_rope_head_dim"]
    mla = [((n, h), (n, d_q)), ((n, d_q), (n, hq * (dh + d_r))), ((n, h), (n, d_kv + d_r)),
           ((n, d_kv), (n, hq * dh)), ((n, d_kv), (n, hq * dh)), ((n, hq * dh), (n, h))]
    assert wgrad_calls[:6] == mla
    assert len(wgrad_calls) == 6 + (4 if "moe" in kinds else 0)


def test_mla_leaves_match_jax_and_carry_over():
    lcfg = _lcfg()
    p_j = jmod.init_mla(jax.random.PRNGKey(0), lcfg, jnp.float32)
    gen = torch.Generator().manual_seed(0)
    p_t = tmod.init_layer("mla", gen, lcfg, tmod.ShardCtx(), torch.float32)
    assert tuple(p_t) == MLA_LEAVES and sorted(p_j) == sorted(MLA_LEAVES)
    assert {k: tuple(v.shape) for k, v in p_t.items()} == \
        {k: tuple(np.shape(v)) for k, v in p_j.items()}
    assert not p_t["ln"].any()
    # the draw order: each weight is the next slice of the generator's stream
    gen = torch.Generator().manual_seed(0)
    sizes = [p_t[k].numel() for k in MLA_LEAVES[1:]]
    stream = torch.randn(sum(sizes), generator=gen)
    for k, (a, n) in zip(MLA_LEAVES[1:], zip(np.cumsum([0] + sizes[:-1]), sizes)):
        ratio = p_t[k].reshape(-1) / stream[a:a + n]
        torch.testing.assert_close(ratio, torch.full_like(ratio, float(ratio[0])))
    # params_from_numpy carries the mla leaves, bf16 cast but the moe router
    cfg_j = jconfigs.get_reduced(ARCH)
    spec = jlm.RunSpec(p=2, n_chunks=1, microbatch=1, seq_len=8, m=2)
    stacked_j, shared_j = jlm.init_params(dataclasses.replace(cfg_j, dtype="bfloat16"), spec,
                                          JaxPlacement.linear(2))
    np_tree = jax.tree_util.tree_map(np.asarray, (stacked_j, shared_j))
    stacked_t, _ = params_from_numpy(*np_tree, device="cpu", dtype=torch.bfloat16)
    mla_t, moe_t = stacked_t[0]["blocks"][0]
    assert sorted(mla_t) == sorted(MLA_LEAVES)  # the JAX tree's keys come sorted
    assert all(mla_t[k].dtype == torch.bfloat16 for k in MLA_LEAVES)
    assert moe_t["router"].dtype == torch.float32
    for k in MLA_LEAVES:
        want = np.asarray(np_tree[0][0]["blocks"][0][0][k]).astype(np.float32)
        np.testing.assert_array_equal(mla_t[k].float().numpy(), want)


def _stacked_by_stage(cfg, spec, placement):
    """The earlier init: every stage's tree from ``init_chunk_params``, then
    stacked."""
    gen = torch.Generator().manual_seed(0)
    ctx = tmod.ShardCtx()
    masks = tlm.group_masks(cfg, spec.p, spec.n_chunks, placement)

    def stack(trees):
        t0 = trees[0]
        if isinstance(t0, dict):
            return {k: stack([t[k] for t in trees]) for k in t0}
        if isinstance(t0, tuple):
            return tuple(stack(list(xs)) for xs in zip(*trees))
        return torch.stack(trees)

    stacked = tuple(stack([tlm.init_chunk_params(cfg, gen, s, c, spec.p, spec.n_chunks, ctx,
                                                 masks) for s in range(spec.p)])
                    for c in range(spec.n_chunks))
    return stacked, tlm.init_shared(cfg, gen, ctx)


@pytest.mark.parametrize("arch", ["internlm2_1_8b", "gpt3_1_5b", "qwen2_moe_a2_7b"])
@pytest.mark.parametrize("p,n_chunks", [(2, 1), (4, 1), (2, 2)])
def test_preallocated_init_keeps_the_seed0_weights(arch, p, n_chunks):
    cfg = configs.get_reduced(arch)
    placement = Placement.linear(p) if n_chunks == 1 else Placement.vshape(p)
    spec = tlm.RunSpec(p=p, n_chunks=n_chunks, microbatch=1, seq_len=8, m=2)
    got = keyed_leaves(tlm.init_params(cfg, spec, placement, seed=0, device="cpu"))
    want = keyed_leaves(_stacked_by_stage(cfg, spec, placement))
    assert [k for k, _ in got] == [k for k, _ in want]
    for (k, a), (_, b) in zip(got, want):
        assert a.dtype == b.dtype and a.is_contiguous(), k
        assert torch.equal(a, b), k


def _block_leaf_shapes(cfg):
    shapes = []
    with tmod.leaves_into(lambda shape, dtype: shapes.append(shape) or
                          torch.empty(shape, dtype=dtype, device="meta")):
        for kinds in tlm.group_layout(cfg, 1, 1)[0]:
            for kind in kinds:
                tmod.init_layer(kind, torch.Generator(), tlm.layer_cfg(cfg), tmod.ShardCtx(),
                                cfg.torch_dtype())
    return shapes


@pytest.mark.parametrize("arch", [a for a in configs.ARCH_IDS + configs.PAPER_IDS
                                  if a != ARCH])
def test_full_width_leaves_are_drawn_whole(arch):
    """Every config ported before deepseek_v3_671b draws each block leaf in
    one piece, so its seed-0 weights are the earlier init's bits."""
    largest = max(int(np.prod(s)) for s in _block_leaf_shapes(configs.get_config(arch)))
    assert largest < tmod.DRAW_SLICE


def test_deepseek_expert_stacks_are_drawn_in_slices(monkeypatch):
    full = _block_leaf_shapes(configs.get_config(ARCH))
    assert (256, 7168, 2048) in full and max(int(np.prod(s)) for s in full) > tmod.DRAW_SLICE
    monkeypatch.setattr(tmod, "DRAW_SLICE", 1000)
    gen = torch.Generator().manual_seed(0)
    leaf = tmod._normal(gen, (8, 64, 32), 0.5, torch.bfloat16)  # 16384: 17 slices
    whole = tmod._normal(torch.Generator().manual_seed(0), (8, 8), 0.5, torch.float32)
    assert leaf.dtype == torch.bfloat16 and tuple(leaf.shape) == (8, 64, 32)
    assert int((leaf == 0).sum()) < 10 and abs(float(leaf.float().std()) - 0.5) < 0.02
    torch.testing.assert_close(whole, torch.randn((8, 8), generator=torch.Generator()
                                                  .manual_seed(0)) * 0.5)


def test_the_published_config_loads():
    cfg = configs.get_config(ARCH)
    ref = jconfigs.get_config(ARCH)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
    assert cfg.block_pattern == (("mla", "moe"),) and cfg.vocab == 129280
    lcfg = tlm.layer_cfg(cfg)
    assert (lcfg["q_lora_rank"], lcfg["kv_lora_rank"], lcfg["qk_rope_head_dim"]) == (1536, 512,
                                                                                     64)
    assert tmod.moe_capacity(lcfg, 1024) == 40 and tmod.moe_capacity(lcfg, 2) == 4
    assert "mla" in tmod.PORTED_KINDS and "mla" not in tmod.UNPORTED_KINDS
    assert ARCH not in configs.UNPORTED_ARCHS


@pytest.mark.parametrize("full", [False, True], ids=["reduced", "full-width"])
def test_state_and_activation_bytes_match_jax(full):
    cfg = configs.get_config(ARCH) if full else configs.get_reduced(ARCH)
    cfg_j = jconfigs.get_config(ARCH) if full else jconfigs.get_reduced(ARCH)
    for n_chunks in (1, 2):
        for p in (2, 4):
            assert fixed_state_bytes(cfg, p, n_chunks) == jax_fixed_state_bytes(cfg_j, p,
                                                                                n_chunks)
    fields = ("m_b_bytes", "m_w_bytes", "per_layer_act", "per_layer_wctx", "layers_per_stage",
              "tokens", "dtype_bytes")
    for b, s in ((1, 1024), (2, 32), (1, 4100)):
        for p, c in ((2, 1), (4, 2)):
            mine = ActivationByteModel.from_config(cfg, b, s, p, n_chunks=c)
            ref = JaxByteModel.from_config(cfg_j, b, s, p, n_chunks=c)
            assert [getattr(mine, f) for f in fields] == [getattr(ref, f) for f in fields]


def test_meta_init_matches_the_real_one():
    """The shapes pass of the preallocated init sees the same leaves in the
    same order as a real draw (deepseek's reduced model, both kinds)."""
    cfg = configs.get_reduced(ARCH)
    spec = tlm.RunSpec(p=2, n_chunks=1, microbatch=1, seq_len=8, m=2)
    stacked, shared = tlm.init_params(cfg, spec, Placement.linear(2), seed=0, device="cpu")
    blocks = stacked[0]["blocks"]
    assert tuple(blocks[0][0]) == MLA_LEAVES and blocks[0][1]["router"].dtype == torch.float32
    assert all(t.shape[0] == 2 and not t.is_meta for t in tree_leaves(blocks))
