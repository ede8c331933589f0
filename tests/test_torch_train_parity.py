"""Parity of the port's training path (``src/repro_torch``) with the JAX package.

Reduced internlm2 in float32 on the CPU, where every wgrad product and every
RMSNorm takes its plain version.  Weights come from the JAX ``init_params``
(carried over with ``repro_torch.interop.params_from_numpy``); inputs,
tokens and accumulators come from numpy with a fixed seed; batches from the
numpy ``SyntheticLM`` both packages share.

(a) attn, mlp and attn+mlp blocks and a whole ``ChunkFBW``: the forward, B's
    dx and W's gradients into an fp32 accumulator against the JAX split
    (``auto_fbw`` / ``ChunkFBW``); W makes exactly 7 ``wgrad_accum`` calls
    per attn+mlp block and B makes none.
(b) loss and gradients of one pipelined step at p in {1, 2, 4} under every
    schedule of the launcher: 1F1B, ZB-H1, ZB-H2 at the stock reduced depth;
    ZB-V, V-Min, V-Half (two chunks on the V placement), ZB-1p and ZB-2p at
    ``n_layers = 2p`` (no padded group); ZB-V once more at the stock depth,
    padded groups included.  Parameters come from the JAX ``init_params`` on
    the schedule's placement.  Reference: the JAX ``PipelineExecutor`` under
    a one-device ``shard_map`` at p=1; at p > 1, ``jax.value_and_grad`` of
    ``make_chunk_fn`` + sink walking the groups in depth order (position
    ``c*p + k`` on stage ``placement.stage_of(c, k)``; a p-device mesh needs
    fake devices set before JAX starts).
(c) 4-step loss trajectories of ``build_train_step`` (AdamW +
    post-validation) against the JAX ``build_train_step`` at p=1 on a
    one-device mesh, under ZB-H1 and under ZB-V (two chunks); and at p in
    {2, 4}, ZB-V from the linear weights relaid by layer (``chip_smoke.py``'s
    helper) against ZB-H1 on the same model, in f32 and in bf16.
(d) a clip-triggering step: ``amended`` is set and the parameters match the
    synchronous ``sync_step`` semantics (JAX at p=1; the port's own ``sync``
    mode at p=2, where stage 0 steps optimistically and must roll back).
(e) ``adamw.step`` and ``adamw.rollback`` against JAX.

Tolerances: f32 losses within 1e-5 and gradients within 1e-4 (the two
frameworks sum in other orders and use other exp/rsqrt implementations; the
gradients pass through a few more such ops than the loss); block outputs
within 1e-5; the 4-step trajectory within 1e-5 relative (rounding carried
through three AdamW updates of lr 3e-3).
"""

import dataclasses
import importlib.util
import pathlib

import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.experimental.shard_map import shard_map  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs import get_reduced as jax_get_reduced  # noqa: E402
from repro.core.executor import PipelineExecutor as JaxPipelineExecutor  # noqa: E402
from repro.core.passes import auto_fbw  # noqa: E402
from repro.core.schedules import compile_plan as jax_compile_plan  # noqa: E402
from repro.core.schedules import one_f_one_b as jax_1f1b  # noqa: E402
from repro.core.schedules import v_half as jax_v_half  # noqa: E402
from repro.core.schedules import v_min as jax_v_min  # noqa: E402
from repro.core.schedules import zb_1p as jax_zb_1p  # noqa: E402
from repro.core.schedules import zb_2p as jax_zb_2p  # noqa: E402
from repro.core.schedules import zb_h1 as jax_zb_h1  # noqa: E402
from repro.core.schedules import zb_h2 as jax_zb_h2  # noqa: E402
from repro.core.schedules import zb_v as jax_zb_v  # noqa: E402
from repro.launch.mesh import AxisBinding  # noqa: E402
from repro.launch.steps import TrainStepConfig as JaxTrainStepConfig  # noqa: E402
from repro.launch.steps import build_train_step as jax_build_train_step  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import modules as jmod  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402

from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.core.executor import PipelineExecutor  # noqa: E402
from repro_torch.core.passes import autograd_fbw  # noqa: E402
from repro_torch.core.schedules import compile_plan, one_f_one_b, zb_h1, zb_h2  # noqa: E402
from repro_torch.core.schedules import v_half, v_min, zb_1p, zb_2p, zb_v  # noqa: E402
from repro_torch.core.schedules.ir import Placement  # noqa: E402
from repro_torch.data import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.interop import params_from_numpy, to_torch  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.launch.steps import TrainStepConfig, build_train_step  # noqa: E402
from repro_torch.launch.train import make_schedule, side_from_batch  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models import modules as tmod  # noqa: E402
from repro_torch.optim import adamw, postval  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

ARCH = "internlm2_1_8b"
BLOCK_TOL = 1e-5
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
TRAJ_RTOL = 1e-5
SCHEDULES = {"1f1b": (one_f_one_b, jax_1f1b), "zb-h1": (zb_h1, jax_zb_h1),
             "zb-h2": (zb_h2, jax_zb_h2), "zb-v": (zb_v, jax_zb_v), "v-min": (v_min, jax_v_min),
             "v-half": (v_half, jax_v_half), "zb-1p": (zb_1p, jax_zb_1p),
             "zb-2p": (zb_2p, jax_zb_2p)}
# (schedule, p, n_layers): None keeps the stock reduced depth (2 layers, so
# p=4 pads two stages, and the V placement at p >= 2 pads groups too)
STEP_CASES = (
    [(n, p, None) for n in ("1f1b", "zb-h1", "zb-h2") for p in (1, 2, 4)]
    + [(n, p, 2 * p) for n in ("zb-v", "v-min", "v-half", "zb-1p", "zb-2p") for p in (1, 2, 4)]
    + [("zb-v", 2, None)]
)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want, tol):
    np.testing.assert_allclose(
        got.detach().float().cpu().numpy(), np.asarray(want, np.float32), rtol=tol, atol=tol
    )


def _close_trees(got, want, tol):
    g_leaves = tree_leaves(got)
    w_leaves = jax.tree_util.tree_leaves(want)
    assert len(g_leaves) == len(w_leaves)
    for a, b in zip(g_leaves, w_leaves):
        assert tuple(a.shape) == tuple(b.shape)
        _close(a, b, tol)


@pytest.fixture
def wgrad_calls(monkeypatch):
    """Counts the calls that reach the wgrad dispatch (``ops.wgrad_accum``)."""
    calls = []
    real = tops.wgrad_accum

    def counting(a, g, acc):
        calls.append((tuple(a.shape), tuple(g.shape)))
        return real(a, g, acc)

    monkeypatch.setattr(tops, "wgrad_accum", counting)
    return calls


# --------------------------------------------------------------------- #
# (a) blocks and a whole chunk: forward, B, W
# --------------------------------------------------------------------- #
def _acc_like(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (rng.standard_normal(np.shape(a)) * 0.1).astype(np.float32), _np(tree))


def _split_both(jax_mod, port_mod, params_j, params_t, x, dy, side_j, side_t, acc):
    y_j, res_j = jax_mod.fwd(params_j, jnp.asarray(x), side_j)
    dx_j, wctx_j = jax_mod.bwd_x(params_j, res_j, jnp.asarray(dy), side_j)
    w_j = jax_mod.bwd_w(params_j, wctx_j, side_j, acc=jax.tree_util.tree_map(jnp.asarray, acc))
    y_t, res_t = port_mod.fwd(params_t, torch.from_numpy(x), side_t)
    dx_t, wctx_t = port_mod.bwd_x(params_t, res_t, torch.from_numpy(dy), side_t)
    return (y_j, dx_j, w_j), (y_t, dx_t, wctx_t)


@pytest.mark.parametrize("kinds", [("attn",), ("mlp",), ("attn", "mlp")])
@pytest.mark.parametrize("mask", [1.0, 0.0])
def test_block_split_matches_jax(kinds, mask, wgrad_calls):
    cfg = get_reduced(ARCH)
    lcfg = tlm.layer_cfg(cfg)
    ctx_j, ctx_t = jmod.ShardCtx(), tmod.ShardCtx()
    kp = tuple(jmod.init_layer(k, jax.random.PRNGKey(7 + i), lcfg, ctx_j, jnp.float32)
               for i, k in enumerate(kinds))
    params_j = (jnp.float32(mask), kp)
    params_t = (torch.tensor(mask), tuple({k: to_torch(np.asarray(v)) for k, v in d.items()}
                                          for d in kp))
    rng = np.random.default_rng(3)
    b, s = 2, 16
    x = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    dy = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    pos = np.arange(s)

    jax_mod = auto_fbw(lambda p, xx, sd: jmod.apply_block(kinds, p[0], p[1], xx, sd["positions"],
                                                           lcfg, ctx_j))
    port_mod = autograd_fbw(lambda p, xx, sd: tmod.apply_block(kinds, p[0], p[1], xx,
                                                               sd["positions"], lcfg, ctx_t))
    acc = _acc_like(params_j, 11)
    (y_j, dx_j, w_j), (y_t, dx_t, wctx_t) = _split_both(
        jax_mod, port_mod, params_j, params_t, x, dy, {"positions": jnp.asarray(pos)},
        {"positions": torch.from_numpy(pos)}, acc)
    _close(y_t, y_j, BLOCK_TOL)
    _close(dx_t, dx_j, BLOCK_TOL)
    assert wgrad_calls == []  # B computes no weight product
    acc_t = tree_map(lambda a: torch.from_numpy(np.array(a)), acc)
    w_t = port_mod.bwd_w(params_t, wctx_t, {"positions": torch.from_numpy(pos)}, acc=acc_t)
    n_linears = {"attn": 4, "mlp": 3}
    assert len(wgrad_calls) == sum(n_linears[k] for k in kinds)
    _close_trees(w_t, w_j, BLOCK_TOL)
    # into a zero accumulator W returns the plain gradients
    zero_acc = jax.tree_util.tree_map(np.zeros_like, acc)
    g_t = port_mod.bwd_w(params_t, wctx_t, {"positions": torch.from_numpy(pos)},
                         acc=tree_map(lambda a: torch.from_numpy(np.array(a)), zero_acc))
    g_j = jax_mod.bwd_w(params_j, jax_mod.bwd_x(params_j, jax_mod.fwd(
        params_j, jnp.asarray(x), {"positions": jnp.asarray(pos)})[1], jnp.asarray(dy),
        {"positions": jnp.asarray(pos)})[1], {"positions": jnp.asarray(pos)},
        acc=jax.tree_util.tree_map(jnp.asarray, zero_acc))
    _close_trees(g_t, g_j, BLOCK_TOL)


@pytest.mark.parametrize("p,stage", [(1, 0), (4, 0), (4, 3)])
def test_chunk_split_matches_jax(p, stage, wgrad_calls):
    """A whole ChunkFBW (stage 3 of p=4 holds only padded blocks, mask 0)."""
    cfg_j, cfg_t = jax_get_reduced(ARCH), get_reduced(ARCH)
    spec = jlm.RunSpec(p=p, n_chunks=1, microbatch=2, seq_len=16, m=2)
    from repro.core.schedules.ir import Placement as JaxPlacement

    stacked_j, shared_j = jlm.init_params(cfg_j, spec, JaxPlacement.linear(p))
    stacked_t, _ = params_from_numpy(_np(stacked_j), _np(shared_j), device="cpu")
    params_j = jax.tree_util.tree_map(lambda a: a[stage], stacked_j[0])
    params_t = tree_map(lambda a: a[stage], stacked_t[0])
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 16, cfg_t.d_model)).astype(np.float32)
    dy = rng.standard_normal((2, 16, cfg_t.d_model)).astype(np.float32)
    pos = np.arange(16)
    jax_mod = jlm.ChunkFBW(cfg_j, p, 1, jmod.ShardCtx(), name="c")
    port_mod = tlm.ChunkFBW(cfg_t, p, 1, tmod.ShardCtx(), name="c")
    acc = _acc_like(params_j, 13)
    (y_j, dx_j, w_j), (y_t, dx_t, wctx_t) = _split_both(
        jax_mod, port_mod, params_j, params_t, x, dy, {"positions": jnp.asarray(pos)},
        {"positions": torch.from_numpy(pos)}, acc)
    _close(y_t, y_j, BLOCK_TOL)
    _close(dx_t, dx_j, BLOCK_TOL)
    assert wgrad_calls == []
    acc_t = tree_map(lambda a: torch.from_numpy(np.array(a)), acc)
    w_t = port_mod.bwd_w(params_t, wctx_t, {"positions": torch.from_numpy(pos)}, acc=acc_t)
    assert len(wgrad_calls) == 7 * len(port_mod.mods)
    _close_trees(w_t, w_j, BLOCK_TOL)


BLOCK_LINEARS = ("wq", "wk", "wv", "wo", "wu", "wg", "wd")


def test_bwd_w_accumulates_block_linears_in_place(wgrad_calls):
    """One W pass adds each block linear's gradient into its accumulator's own
    storage (``ops.wgrad_accum`` updates in place): the returned leaf is the
    accumulator passed in, at its old address, holding the JAX split's sum."""
    from repro.core.schedules.ir import Placement as JaxPlacement

    cfg_j, cfg_t = jax_get_reduced(ARCH), get_reduced(ARCH)
    spec = jlm.RunSpec(p=1, n_chunks=1, microbatch=2, seq_len=16, m=1)
    stacked_j, shared_j = jlm.init_params(cfg_j, spec, JaxPlacement.linear(1))
    stacked_t, _ = params_from_numpy(_np(stacked_j), _np(shared_j), device="cpu")
    params_j = jax.tree_util.tree_map(lambda a: a[0], stacked_j[0])
    params_t = tree_map(lambda a: a[0], stacked_t[0])
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 16, cfg_t.d_model)).astype(np.float32)
    dy = rng.standard_normal((2, 16, cfg_t.d_model)).astype(np.float32)
    pos = np.arange(16)
    jax_mod = jlm.ChunkFBW(cfg_j, 1, 1, jmod.ShardCtx(), name="c")
    port_mod = tlm.ChunkFBW(cfg_t, 1, 1, tmod.ShardCtx(), name="c")
    acc = _acc_like(params_j, 17)
    (_, _, w_j), (_, _, wctx_t) = _split_both(
        jax_mod, port_mod, params_j, params_t, x, dy, {"positions": jnp.asarray(pos)},
        {"positions": torch.from_numpy(pos)}, acc)
    acc_t = tree_map(lambda a: torch.from_numpy(np.array(a)), acc)
    linears = [(blk, name) for kinds in acc_t["blocks"] for blk in kinds for name in blk
               if name in BLOCK_LINEARS]
    ptrs = [blk[name].data_ptr() for blk, name in linears]
    w_t = port_mod.bwd_w(params_t, wctx_t, {"positions": torch.from_numpy(pos)}, acc=acc_t)
    out = [blk[name] for kinds in w_t["blocks"] for blk in kinds for name in blk
           if name in BLOCK_LINEARS]
    assert len(out) == len(linears) == len(wgrad_calls) == 7 * len(port_mod.mods)
    for (blk, name), ptr, leaf in zip(linears, ptrs, out):
        assert leaf is blk[name] and leaf.data_ptr() == ptr, name
    _close_trees(w_t, w_j, BLOCK_TOL)


# --------------------------------------------------------------------- #
# (b) one pipelined step: loss and gradients
# --------------------------------------------------------------------- #
def _setup(p, m, b=2, s=16, seed=0, placement=None, n_layers=None):
    """Both packages' config, spec, JAX-initialised parameters on
    ``placement`` (the JAX one; linear by default) and numpy side inputs;
    ``n_layers`` replaces the reduced depth in both packages."""
    from repro.core.schedules.ir import Placement as JaxPlacement

    placement = placement or JaxPlacement.linear(p)
    cfg_j, cfg_t = jax_get_reduced(ARCH), get_reduced(ARCH)
    if n_layers is not None:
        cfg_j = dataclasses.replace(cfg_j, n_layers=n_layers)
        cfg_t = dataclasses.replace(cfg_t, n_layers=n_layers)
    C = placement.n_chunks
    spec_j = jlm.RunSpec(p=p, n_chunks=C, microbatch=b, seq_len=s, m=m)
    stacked_j, shared_j = jlm.init_params(cfg_j, spec_j, placement,
                                          key=jax.random.PRNGKey(seed))
    stacked_t, shared_t = params_from_numpy(_np(stacked_j), _np(shared_j), device="cpu")
    spec_t = tlm.RunSpec(p=p, n_chunks=C, microbatch=b, seq_len=s, m=m)
    side_np = tlm.side_inputs(cfg_t, spec_t, seed=seed + 100)  # numpy: fed to both packages
    # integer tokens, labels and positions; a vlm or encdec front's float32 embeddings
    side_j = {k: jnp.asarray(v, jnp.int32 if v.dtype.kind == "i" else jnp.float32)
              for k, v in side_np.items()}
    side_t = {k: torch.as_tensor(v, dtype=torch.long if v.dtype.kind == "i" else torch.float32)
              for k, v in side_np.items()}
    return cfg_j, cfg_t, spec_j, spec_t, (stacked_j, shared_j, side_j), (stacked_t, shared_t, side_t)


def _jax_executor_grads(cfg, spec, jax_sched, stacked, shared, side):
    """p=1: the JAX PipelineExecutor under a one-device shard_map."""
    plan = jax_compile_plan(jax_sched)
    program = jlm.build_program(cfg, spec, jax_sched.placement)
    grad_fn = JaxPipelineExecutor(program, plan, pipe_axis="pipe").build_grad_fn()
    mesh = jax.make_mesh((1,), ("pipe",))

    def body(stacked_local, shared, side):
        local = tuple(jax.tree_util.tree_map(lambda a: a[0], sp) for sp in stacked_local)
        grads, shared_grads, loss = grad_fn(local, shared, side)
        return (tuple(jax.tree_util.tree_map(lambda a: a[None], g) for g in grads),
                shared_grads, loss)

    spec_stacked = tuple(jax.tree_util.tree_map(lambda _: P("pipe"), sp) for sp in stacked)
    fn = shard_map(body, mesh=mesh, in_specs=(spec_stacked, P(), P()),
                   out_specs=(spec_stacked, P(), P()), check_rep=False)
    return jax.device_get(jax.jit(fn)(stacked, shared, side))


_BY_STAGE_CACHE = {}


def _jax_by_stage_grads(cfg, spec, placement, stacked, shared, side):
    """p>1: jax.value_and_grad of the groups applied in depth order: position
    ``pos = c*p + k`` is chunk c's group on stage ``placement.stage_of(c, k)``
    (for one linear chunk, the stages one after another)."""
    key = (cfg, spec.p, spec.m, placement.stage_seq)
    if key in _BY_STAGE_CACHE:
        return _BY_STAGE_CACHE[key]
    ctx = jmod.ShardCtx()
    chunk_fn, _, _ = jlm.make_chunk_fn(cfg, spec.p, spec.n_chunks, ctx)
    src_fwd, _ = jlm.make_src(cfg, ctx)
    sink_fn = jlm.make_sink_fn(cfg, ctx, spec.m)

    def total(stacked, shared):
        loss = jnp.zeros((), jnp.float32)
        for j in range(spec.m):
            side_j = jax.tree_util.tree_map(lambda a: a[j], side)
            x = src_fwd(shared, side_j)
            for pos in range(spec.n_chunks * spec.p):
                c, k = divmod(pos, spec.p)
                st = placement.stage_of(c, k)
                x = chunk_fn(jax.tree_util.tree_map(lambda a: a[st], stacked[c]), x, side_j)
            loss = loss + sink_fn(shared, x, side_j)
        return loss

    loss, (g_stacked, g_shared) = jax.jit(jax.value_and_grad(total, argnums=(0, 1)))(
        stacked, shared)
    out = jax.device_get((g_stacked, g_shared, loss))
    _BY_STAGE_CACHE[key] = out
    return out


@pytest.mark.parametrize(
    "name,p,n_layers", STEP_CASES,
    ids=[f"{p}-{n}" + ("" if nl is None else f"-{nl}L") for n, p, nl in STEP_CASES])
def test_pipelined_step_matches_jax(name, p, n_layers):
    check_pipelined_step(name, p, n_layers)


def check_pipelined_step(name, p, n_layers, m=4):
    """One pipelined step of the port's eager walk under ``name`` against the
    JAX package: loss within LOSS_TOL, every gradient leaf (fp32) within
    GRAD_TOL.  Returns the port's (grads, shared_grads, loss)."""
    port_sched, jax_sched = SCHEDULES[name][0](p, m), SCHEDULES[name][1](p, m)
    cfg_j, cfg_t, spec_j, spec_t, (st_j, sh_j, side_j), (st_t, sh_t, side_t) = _setup(
        p, m, placement=jax_sched.placement, n_layers=n_layers)
    assert port_sched.placement.stage_seq == jax_sched.placement.stage_seq
    assert len(st_t) == port_sched.n_chunks
    if p == 1:
        g_j, sg_j, loss_j = _jax_executor_grads(cfg_j, spec_j, jax_sched, st_j, sh_j, side_j)
    else:
        g_j, sg_j, loss_j = _jax_by_stage_grads(cfg_j, spec_j, jax_sched.placement, st_j, sh_j,
                                                side_j)
    program = tlm.build_program(cfg_t, spec_t, port_sched.placement)
    grad_fn = PipelineExecutor(program, compile_plan(port_sched)).build_grad_fn()
    g_t, sg_t, loss_t = grad_fn(st_t, sh_t, side_t)
    assert loss_t.dtype == torch.float32
    _close(loss_t, loss_j, LOSS_TOL)
    _close_trees(g_t, g_j, GRAD_TOL)
    _close_trees(sg_t, sg_j, GRAD_TOL)
    for leaf in tree_leaves((g_t, sg_t)):
        assert leaf.dtype == torch.float32
    return g_t, sg_t, loss_t


def test_wgrad_launches_per_step(wgrad_calls):
    """Every W op of every block linear reaches the wgrad dispatch once:
    7 linears x blocks per chunk x p stages x m microbatches."""
    p, m = 2, 3
    _, cfg_t, _, spec_t, _, (st_t, sh_t, side_t) = _setup(p, m)
    sched = zb_h1(p, m)
    program = tlm.build_program(cfg_t, spec_t, sched.placement)
    PipelineExecutor(program, compile_plan(sched)).build_grad_fn()(st_t, sh_t, side_t)
    blocks = len(program.chunks[0].mods)
    assert len(wgrad_calls) == 7 * blocks * p * m


# --------------------------------------------------------------------- #
# (c) 4-step trajectory of the whole training step; (d) clipping
# --------------------------------------------------------------------- #
def _jax_train(cfg, spec, stacked, shared, batches, acfg, postval_mode, sched=None):
    sched = sched or jax_zb_h1(1, spec.m)
    mesh = jax.make_mesh((1,), ("data",))
    binding = AxisBinding(pipe="data", tp=None, dp=None)
    tcfg = JaxTrainStepConfig(adamw=acfg, postval_mode=postval_mode, donate=False)
    make, _ = jax_build_train_step(cfg, spec, jax_compile_plan(sched), sched.placement,
                                   mesh, binding, tcfg)
    zeros = lambda t: jax.tree_util.tree_map(lambda a: jnp.zeros(a.shape, jnp.float32), t)  # noqa
    opt = jadamw.AdamWState(t=jnp.zeros((), jnp.int32), m=zeros(stacked), v=zeros(stacked))
    sopt = jadamw.AdamWState(t=jnp.zeros((), jnp.int32), m=zeros(shared), v=zeros(shared))
    step = None
    out = []
    for batch in batches:
        side = {
            "tokens": jnp.asarray(batch["tokens"].reshape(spec.m, spec.microbatch, -1)),
            "labels": jnp.asarray(batch["labels"].reshape(spec.m, spec.microbatch, -1)),
            "positions": jnp.broadcast_to(jnp.arange(spec.seq_len), (spec.m, spec.seq_len)),
        }
        step = step or make(side)
        stacked, shared, opt, sopt, met = step(stacked, shared, opt, sopt, side)
        out.append({k: np.asarray(v) for k, v in met.items()})
    return out, jax.device_get((stacked, shared))


def _port_train(cfg, spec, sched, stacked, shared, batches, acfg, postval_mode):
    step, _ = build_train_step(cfg, spec, compile_plan(sched), sched.placement,
                               TrainStepConfig(adamw=acfg, postval_mode=postval_mode))
    opt, sopt = adamw.init(stacked), adamw.init(shared)
    out = []
    for batch in batches:
        side = side_from_batch(batch, spec, "cpu")
        stacked, shared, opt, sopt, met = step(stacked, shared, opt, sopt, side)
        out.append(met)
    return out, (stacked, shared)


def _batches(cfg, spec, n):
    data = SyntheticLM(DataConfig(global_batch=spec.m * spec.microbatch, seq_len=spec.seq_len,
                                  vocab=cfg.vocab))
    return [data.batch_at(k) for k in range(n)]


def _check_trajectory(name):
    port_sched, jax_sched = SCHEDULES[name][0](1, 4), SCHEDULES[name][1](1, 4)
    cfg_j, cfg_t, spec_j, spec_t, (st_j, sh_j, _), (st_t, sh_t, _) = _setup(
        1, 4, s=32, placement=jax_sched.placement)
    batches = _batches(cfg_t, spec_t, 4)
    acfg_j, acfg_t = jadamw.AdamWConfig(lr=3e-3), adamw.AdamWConfig(lr=3e-3)
    ref, _ = _jax_train(cfg_j, spec_j, st_j, sh_j, batches, acfg_j, "within_step", jax_sched)
    got, _ = _port_train(cfg_t, spec_t, port_sched, st_t, sh_t, batches, acfg_t, "within_step")
    losses_j = [float(r["loss"]) for r in ref]
    losses_t = [float(g["loss"]) for g in got]
    np.testing.assert_allclose(losses_t, losses_j, rtol=TRAJ_RTOL, atol=0)
    np.testing.assert_allclose([float(g["grad_norm"]) for g in got],
                               [float(r["grad_norm"]) for r in ref], rtol=GRAD_TOL)
    assert [bool(g["amended"]) for g in got] == [bool(r["amended"]) for r in ref]
    assert losses_t[-1] < losses_t[0]


def test_train_trajectory_matches_jax():
    _check_trajectory("zb-h1")


def test_zbv_train_trajectory_matches_jax():
    """Two chunks on the V placement (p=1: chunk 0's output is handed to
    chunk 1 on the same stage), through AdamW and post-validation."""
    _check_trajectory("zb-v")


def _chip_smoke():
    """``chip_smoke.py`` as a module: its ``relay_to_placement`` lays the
    linear placement's weights onto the V placement for the card's run."""
    path = pathlib.Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _placement_run(p, name, dtype, postval_mode, steps=4, m=8, decisions=None):
    """``steps`` AdamW + post-validation steps (clip 1.0, lr 3e-3) of the
    reduced model with ``n_layers = 2p`` under ``name``, from the seed-0
    weights of the linear placement (relaid by layer onto the V placement);
    returns [(loss, grad_norm)] per step.  ``decisions``, if given, gets an
    empty list at the start of each step for the caller's hook to fill."""
    cfg = dataclasses.replace(get_reduced(ARCH), n_layers=2 * p, dtype=dtype)
    sched = make_schedule(name, p, m)
    spec = tlm.RunSpec(p=p, n_chunks=sched.n_chunks, microbatch=2, seq_len=32, m=m)
    lin_spec = tlm.RunSpec(p=p, n_chunks=1, microbatch=2, seq_len=32, m=m)
    stacked, shared = tlm.init_params(cfg, lin_spec, Placement.linear(p), seed=0, device="cpu")
    if sched.n_chunks != 1:
        stacked = _chip_smoke().relay_to_placement(cfg, stacked, sched.placement)
    tcfg = TrainStepConfig(adamw=adamw.AdamWConfig(lr=3e-3, grad_clip=1.0),
                           postval_mode=postval_mode)
    step, _ = build_train_step(cfg, spec, compile_plan(sched), sched.placement, tcfg)
    opt, sopt = adamw.init(stacked), adamw.init(shared)
    out = []
    for batch in _batches(cfg, spec, steps):
        if decisions is not None:
            decisions.append([])
        side = side_from_batch(batch, spec, "cpu")
        stacked, shared, opt, sopt, met = step(stacked, shared, opt, sopt, side)
        out.append((float(met["loss"]), float(met["grad_norm"])))
    return out


@pytest.mark.parametrize("postval_mode,dtype,p", [
    ("within_step", "float32", 2), ("within_step", "float32", 4),
    ("sync", "bfloat16", 2), ("sync", "bfloat16", 4)])
def test_v_placement_trains_like_the_linear_one(postval_mode, dtype, p):
    """The same model on two placements trains alike at p > 1: zb-v from the
    linear weights relaid by layer against zb-h1, through clipping, AdamW and
    post-validation.  Only the order in which the gradient's squares are
    summed differs (a stage holds other layers), so the trajectories agree to
    rounding.  In bf16 a sum that differs in its last bit moves the clip
    scale by one ulp, which the weights' rounding amplifies (on the
    full-width model, ``tools/placement_gap.py``); here the sums agree, and
    bf16 runs synchronously: see
    ``test_v_placement_bf16_gap_comes_from_rollback`` for the speculative mode."""
    lin = _placement_run(p, "zb-h1", dtype, postval_mode)
    v = _placement_run(p, "zb-v", dtype, postval_mode)
    np.testing.assert_allclose(np.array(v), np.array(lin), rtol=TRAJ_RTOL, atol=0)


def test_v_placement_bf16_gap_comes_from_rollback(monkeypatch):
    """With bf16 weights and speculative post-validation the two placements
    part after the step where stage 0's optimistic decision differs between
    them: its prefix of the gradient norm covers other layers (layers 0-1
    under the linear placement, 0 and 3 under the V), so one placement steps
    and rolls back where the other waits, and the rollback is exact only up
    to bf16 rounding.  Up to that step and under sync the steps are equal."""
    decisions = []

    def record(partial, cfg):
        dec = decide_partial(partial, cfg)
        decisions[-1].append(dec.applied)
        return dec

    decide_partial = postval.decide_partial
    monkeypatch.setattr(postval, "decide_partial", record)
    runs = {}
    for name in ("zb-h1", "zb-v"):
        decisions.clear()
        losses = _placement_run(2, name, "bfloat16", "within_step", steps=5,
                                decisions=decisions)
        runs[name] = (losses, [list(d) for d in decisions])
    (lin, dec_lin), (v, dec_v) = runs["zb-h1"], runs["zb-v"]
    first_split = next(k for k in range(5) if dec_lin[k] != dec_v[k])
    assert v[:first_split + 1] == lin[:first_split + 1]
    assert v[first_split + 1:] != lin[first_split + 1:]
    np.testing.assert_allclose(np.array(v)[:, 0], np.array(lin)[:, 0], rtol=1e-4, atol=0)


def test_clipped_step_matches_jax_sync():
    """grad_clip far below the gradient norm: the optimistic step (p=1: the
    prefix is the whole) skips, validation redoes it at the clip scale."""
    cfg_j, cfg_t, spec_j, spec_t, (st_j, sh_j, _), (st_t, sh_t, _) = _setup(1, 2, s=16)
    batches = _batches(cfg_t, spec_t, 2)
    acfg_j = jadamw.AdamWConfig(lr=3e-3, grad_clip=0.05)
    acfg_t = adamw.AdamWConfig(lr=3e-3, grad_clip=0.05)
    ref_sync, (pj, sj) = _jax_train(cfg_j, spec_j, st_j, sh_j, batches, acfg_j, "sync")
    ref_within, _ = _jax_train(cfg_j, spec_j, st_j, sh_j, batches, acfg_j, "within_step")
    got, (pt, s_t) = _port_train(cfg_t, spec_t, zb_h1(1, 2), st_t, sh_t, batches, acfg_t,
                                 "within_step")
    assert [bool(g["amended"]) for g in got] == [bool(r["amended"]) for r in ref_within]
    assert all(bool(g["amended"]) for g in got)
    assert all(float(g["grad_norm"]) > 0.05 for g in got)
    _close_trees(pt, pj, GRAD_TOL)
    _close_trees(s_t, sj, GRAD_TOL)


def test_rollback_at_p2_matches_sync():
    """p=2 with the clip between stage 0's prefix norm and the full norm:
    stage 0 steps optimistically, then rolls back exactly and redoes the
    step at the clip scale; stage 1 skips and redoes.  The result is the
    synchronous step's, to f32 rounding of the rollback."""
    _, cfg_t, _, spec_t, _, (st_t, sh_t, side_t) = _setup(2, 2, s=16)
    sched = zb_h1(2, 2)
    program = tlm.build_program(cfg_t, spec_t, sched.placement)
    g, sg, _ = PipelineExecutor(program, compile_plan(sched)).build_grad_fn()(st_t, sh_t, side_t)
    stage0 = postval.local_stats((tree_map(lambda a: a[0], g[0]), sg)).sumsq
    full = postval.local_stats((g, sg)).sumsq
    assert stage0 < full
    clip = float((torch.sqrt(stage0) + torch.sqrt(full)) / 2)
    acfg = adamw.AdamWConfig(lr=3e-3, grad_clip=clip)
    batch = {"tokens": side_t["tokens"].reshape(-1, 16).numpy(),
             "labels": side_t["labels"].reshape(-1, 16).numpy()}
    copy = lambda t: tree_map(lambda a: a.clone(), t)  # noqa: E731
    got, (pw, sw) = _port_train(cfg_t, spec_t, sched, copy(st_t), copy(sh_t), [batch], acfg,
                                "within_step")
    ref, (ps, ss) = _port_train(cfg_t, spec_t, sched, copy(st_t), copy(sh_t), [batch], acfg, "sync")
    assert bool(got[0]["amended"]) and not bool(ref[0]["amended"])
    for a, b in zip(tree_leaves((pw, sw)), tree_leaves((ps, ss))):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


# --------------------------------------------------------------------- #
# (e) AdamW step and rollback
# --------------------------------------------------------------------- #
def test_adamw_step_and_rollback_match_jax():
    rng = np.random.default_rng(9)
    shapes = {"w": (6, 5), "b": (5,), "s": ()}
    params = {k: (rng.standard_normal(v) * 0.3).astype(np.float32) for k, v in shapes.items()}
    grads = {k: (rng.standard_normal(v) * 0.1).astype(np.float32) for k, v in shapes.items()}
    m = {k: (rng.standard_normal(v) * 0.01).astype(np.float32) for k, v in shapes.items()}
    v = {k: np.abs(rng.standard_normal(v) * 0.01).astype(np.float32) for k, v in shapes.items()}
    j = lambda t: jax.tree_util.tree_map(jnp.asarray, t)  # noqa: E731
    t_ = lambda t: tree_map(lambda a: torch.from_numpy(np.array(a)), t)  # noqa: E731
    cfg_j, cfg_t = jadamw.AdamWConfig(lr=1e-2), adamw.AdamWConfig(lr=1e-2)
    st_j = jadamw.AdamWState(t=jnp.int32(3), m=j(m), v=j(v))
    st_t = adamw.AdamWState(t=torch.tensor(3, dtype=torch.int32), m=t_(m), v=t_(v))
    for scale in (1.0, 0.37):
        pj, sj = jadamw.step(j(params), st_j, j(grads), cfg_j, scale=jnp.float32(scale))
        pt, s_t = adamw.step(t_(params), st_t, t_(grads), cfg_t, scale=torch.tensor(scale))
        assert int(s_t.t) == int(sj.t) == 4
        for got, want in ((pt, pj), (s_t.m, sj.m), (s_t.v, sj.v)):
            _close_trees(got, want, 1e-6)
        rj, rsj = jadamw.rollback(pj, sj, j(grads), cfg_j, scale=jnp.float32(scale))
        rt, rst = adamw.rollback(pt, s_t, t_(grads), cfg_t, scale=torch.tensor(scale))
        assert int(rst.t) == int(rsj.t) == 3
        for got, want in ((rt, rj), (rst.m, rsj.m), (rst.v, rsj.v)):
            _close_trees(got, want, 1e-6)
        _close_trees(rt, params, 1e-6)  # the rollback undoes the step
    z = adamw.init(t_(params))
    assert int(z.t) == 0 and all(float(a.abs().sum()) == 0 for a in tree_leaves((z.m, z.v)))


def test_bf16_params_step_keeps_dtypes():
    """bf16 parameters: fp32 moments and grads, the update cast back."""
    cfg = dataclasses.replace(get_reduced(ARCH), dtype="bfloat16")
    spec = tlm.RunSpec(p=2, n_chunks=1, microbatch=1, seq_len=8, m=2)
    sched = zb_h2(2, 2)
    stacked, shared = tlm.init_params(cfg, spec, sched.placement, seed=3, device="cpu")
    before = [a.clone() for a in tree_leaves(stacked)]
    got, (st, sh) = _port_train(cfg, spec, sched, stacked, shared, _batches(cfg, spec, 1),
                                adamw.AdamWConfig(lr=1e-2), "within_step")
    assert np.isfinite(float(got[0]["loss"]))
    assert all(a.dtype == b.dtype for a, b in zip(tree_leaves(st), before))
    assert any(not torch.equal(a, b) for a, b in zip(tree_leaves(st), before))


# --------------------------------------------------------------------- #
# the executor's own checks
# --------------------------------------------------------------------- #
def _grads(p, m, sched, plan=None):
    _, cfg_t, _, spec_t, _, (st_t, sh_t, side_t) = _setup(p, m)
    program = tlm.build_program(cfg_t, spec_t, sched.placement)
    return PipelineExecutor(program, plan or compile_plan(sched)).build_grad_fn()(st_t, sh_t, side_t)


def test_gpipe_gives_the_same_step():
    """GPipe's order (all F, then B and W) gives 1F1B's loss and gradients."""
    from repro_torch.core.schedules import gpipe

    ref = _grads(2, 3, one_f_one_b(2, 3))
    for a, b in zip(tree_leaves(_grads(2, 3, gpipe(2, 3))), tree_leaves(ref)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_executor_raises_on_a_slot_still_live():
    sched = zb_h2(2, 4)
    plan = compile_plan(sched)
    assert plan.n_res_slots_joint > 1
    plan.op_res_slot_joint = np.where(plan.op_res_slot_joint >= 0, 0, -1)
    with pytest.raises(RuntimeError, match="written while still live"):
        _grads(2, 4, sched, plan=plan)


def test_executor_raises_on_a_missing_message():
    sched = one_f_one_b(2, 2)
    plan = compile_plan(sched)
    t = int(np.nonzero(plan.recv_valid[1].any(axis=-1))[0][0])
    plan.send_channel = plan.send_channel.copy()
    plan.send_channel[0, t] = -1
    with pytest.raises(RuntimeError, match="sent nothing"):
        _grads(2, 2, sched, plan=plan)


def test_executor_refuses_a_plan_of_other_chunks():
    _, cfg_t, _, spec_t, _, _ = _setup(2, 2)
    program = tlm.build_program(cfg_t, spec_t, zb_h1(2, 2).placement)
    program.chunks = list(program.chunks) * 2
    with pytest.raises(ValueError, match="chunks"):
        PipelineExecutor(program, compile_plan(zb_h1(2, 2)))


def _v_setup(p, m, n_layers=None):
    from repro.core.schedules.ir import Placement as JaxPlacement

    _, cfg_t, _, spec_t, _, (st_t, sh_t, side_t) = _setup(
        p, m, placement=JaxPlacement.vshape(p), n_layers=n_layers)
    return cfg_t, spec_t, st_t, sh_t, side_t


def test_v_plan_turns_locally_and_the_executor_follows_it():
    """Under ZB-V the last stage hands chunk 0's output to its own chunk 1
    (an activation) and chunk 1's input gradient to its own chunk 0 (a
    gradient) without a channel; a plan that files the turn under the wrong
    chunk's inbox makes the executor raise instead of computing."""
    p, m = 2, 3
    sched = zb_v(p, m)
    plan = compile_plan(sched)
    turn = p - 1
    fwd = [t for t in range(plan.n_ticks) if plan.op_kind[turn, t] == 1
           and plan.op_chunk[turn, t] == 0]
    bwd = [t for t in range(plan.n_ticks) if plan.op_kind[turn, t] == 2
           and plan.op_chunk[turn, t] == 1]
    assert len(fwd) == len(bwd) == m
    for t in fwd:
        assert plan.send_local[turn, t] and plan.send_channel[turn, t] == -1
        assert plan.local_chunk[turn, t] == 1 and not plan.local_is_grad[turn, t]
    for t in bwd:
        assert plan.send_local[turn, t] and plan.send_channel[turn, t] == -1
        assert plan.local_chunk[turn, t] == 0 and plan.local_is_grad[turn, t]
    assert int(plan.send_local.sum()) == 2 * m  # nowhere else
    # every per-chunk inbox of the plan is used by both chunks
    assert min(plan.n_act_slots) >= 1 and min(plan.n_grad_slots) >= 1

    cfg_t, spec_t, st_t, sh_t, side_t = _v_setup(p, m)
    program = tlm.build_program(cfg_t, spec_t, sched.placement)
    bad = compile_plan(sched)
    bad.local_chunk = bad.local_chunk.copy()
    bad.local_chunk[turn, fwd[0]] = 0
    with pytest.raises(RuntimeError, match="read before it was written|still live"):
        PipelineExecutor(program, bad).build_grad_fn()(st_t, sh_t, side_t)


def test_executor_refuses_a_v_plan_for_one_chunk():
    _, cfg_t, _, spec_t, _, _ = _setup(2, 2)
    program = tlm.build_program(cfg_t, spec_t, zb_h1(2, 2).placement)
    with pytest.raises(ValueError, match="program has 1 chunks, plan 2"):
        PipelineExecutor(program, compile_plan(zb_v(2, 2)))


def test_v_step_fills_both_chunks_accumulators(wgrad_calls):
    """Two chunks on every stage: each (chunk, stage) accumulator gets its
    own gradient (none stays zero), and every W op of every block linear
    reaches the wgrad dispatch once: 7 x blocks x p x 2 chunks x m."""
    p, m = 2, 3
    cfg_t, spec_t, st_t, sh_t, side_t = _v_setup(p, m, n_layers=2 * p)
    sched = zb_v(p, m)
    program = tlm.build_program(cfg_t, spec_t, sched.placement)
    grads, _, _ = PipelineExecutor(program, compile_plan(sched)).build_grad_fn()(
        st_t, sh_t, side_t)
    assert len(grads) == 2
    blocks = len(program.chunks[0].mods)
    assert len(wgrad_calls) == 7 * blocks * p * 2 * m
    for c in range(2):
        for st in range(p):
            wq = grads[c]["blocks"][0][0]["wq"][st]
            assert float(wq.abs().sum()) > 0, (c, st)
    # chunk 1 on stage 0 is the last group before the sink, chunk 0 on stage 0 the first:
    # their gradients differ (a placement mix-up would swap or alias them)
    assert not torch.equal(grads[0]["blocks"][0][0]["wq"][0], grads[1]["blocks"][0][0]["wq"][0])


def test_train_step_leaves_no_reference_cycles():
    """Everything a training step allocates is freed by reference counting:
    a cycle (e.g. a recursive closure holding flattened leaves) would keep
    activations and replaced fp32 accumulators alive until the next gc
    pass -- on the card that inflated peak memory by ~20 GB."""
    import gc

    _, cfg_t, _, spec_t, _, (st_t, sh_t, _) = _setup(2, 3)
    sched = zb_h2(2, 3)
    batches = _batches(cfg_t, spec_t, 2)
    _port_train(cfg_t, spec_t, sched, st_t, sh_t, batches[:1], adamw.AdamWConfig(), "within_step")
    gc.collect()
    was_enabled = gc.isenabled()
    gc.disable()
    gc.set_debug(gc.DEBUG_SAVEALL)
    try:
        _port_train(cfg_t, spec_t, sched, st_t, sh_t, batches, adamw.AdamWConfig(), "within_step")
        assert gc.collect() == 0, sorted({type(o).__name__ for o in gc.garbage})[:10]
    finally:
        gc.set_debug(0)
        gc.garbage.clear()
        if was_enabled:
            gc.enable()
