"""Reduced ``xlstm_350m`` (mlstm, slstm blocks) and ``recurrentgemma_9b``
(rglru + mlp, attn_local + mlp blocks) trained by the port against the JAX
package, in float32 on the CPU.

* One pipelined step of each arch at p in {1, 2} under 1F1B, ZB-H1, ZB-H2
  and ZB-V, m=2: loss within 1e-5 and every gradient leaf within 1e-4,
  through ``test_torch_train_parity.py``'s harness with its arch set to
  the recurrent model, at the reduced depth (4 and 3 layers: p=2 and the V
  placement pad groups with masked blocks).  The other four schedules run
  the same blocks through the same executor (the dense, moe, mla, vlm and
  encdec files hold all eight).  The reference is JAX's gradient of the
  groups in depth order at every p (``_by_stage_grads``: the chain rule
  over JAX's VJPs of the source, each group and the sink): the JAX split of
  a scan body fails on jax 0.9 (ROADMAP Queue 3), so the JAX executor
  cannot train xlstm, and one reference a placement serves the three
  linear schedules.
* W of one step: 5 ``wgrad_accum`` calls a sLSTM block, 6 an mLSTM block
  (``mfg`` and ``mig`` n_heads wide), 8 a rglru + mlp block, 7 an
  attn_local + mlp block.
* A checkpoint that the JAX store wrote for each arch restores in the
  port, whose step on it gives the JAX loss and gradients.
* The training launcher takes both archs: a reduced CPU run, losses fall.
"""

import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse)

import jax  # noqa: E402
import numpy as np  # noqa: E402
import test_torch_train_parity as train_harness  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import modules as jmod  # noqa: E402
from test_torch_train_parity import wgrad_calls  # noqa: E402,F401

ARCHS = ("xlstm_350m", "recurrentgemma_9b")
CASES = [(a, n, p) for a in ARCHS for n in ("1f1b", "zb-h1", "zb-h2", "zb-v") for p in (1, 2)]
LINEARS = {"slstm": 5, "mlstm": 6, "rglru": 5, "attn_local": 4, "mlp": 3}


_BY_STAGE_CACHE = {}


def _by_stage_grads(cfg, spec, placement, stacked, shared, side):
    """jax.value_and_grad of the groups applied in depth order (the
    harness's ``_jax_by_stage_grads``: position ``c*p + k`` is chunk c's
    group on stage ``placement.stage_of(c, k)``), by the chain rule over
    JAX's own VJPs of one microbatch's source, each group and the sink: the
    same function and JAX's autodiff of it, with one compile of each piece
    where the harness compiles the whole unrolled walk (m microbatches x p
    x chunks groups, each with the recurrent kinds' scans: ~30 s at the V
    placement).  Cached by config and placement, as the harness's is."""
    key = (cfg, spec.p, spec.m, placement.stage_seq)
    if key in _BY_STAGE_CACHE:
        return _BY_STAGE_CACHE[key]
    ctx = jmod.ShardCtx()
    chunk_fn, _, _ = jlm.make_chunk_fn(cfg, spec.p, spec.n_chunks, ctx)
    src_fwd, _ = jlm.make_src(cfg, ctx)
    sink_fn = jlm.make_sink_fn(cfg, ctx, spec.m)
    group_f = jax.jit(chunk_fn)
    group_b = jax.jit(lambda prm, x, sd, g: jax.vjp(lambda a, b: chunk_fn(a, b, sd), prm, x)[1](g))
    src_f = jax.jit(src_fwd)
    src_b = jax.jit(lambda sh, sd, g: jax.vjp(lambda a: src_fwd(a, sd), sh)[1](g)[0])
    sink_vg = jax.jit(jax.value_and_grad(sink_fn, argnums=(0, 1)))
    tm, leaves = jax.tree_util.tree_map, jax.tree_util.tree_leaves
    g_stacked = tm(lambda a: np.zeros(a.shape, a.dtype), stacked)
    g_shared = tm(lambda a: np.zeros(a.shape, a.dtype), shared)
    loss = np.float32(0.0)
    at = [(c, placement.stage_of(c, k)) for c, k in
          (divmod(pos, spec.p) for pos in range(spec.n_chunks * spec.p))]
    for j in range(spec.m):
        side_j = tm(lambda a: a[j], side)
        xs = [src_f(shared, side_j)]
        for c, st in at:
            xs.append(group_f(tm(lambda a: a[st], stacked[c]), xs[-1], side_j))
        loss_j, (g_sh, gx) = sink_vg(shared, xs.pop(), side_j)
        loss = loss + np.float32(loss_j)
        for pos in reversed(range(len(at))):
            c, st = at[pos]
            g_prm, gx = group_b(tm(lambda a: a[st], stacked[c]), xs[pos], side_j, gx)
            for acc, g in zip(leaves(g_stacked[c]), leaves(g_prm)):
                acc[st] += np.asarray(g)
        g_src = src_b(shared, side_j, gx)
        for acc, g1, g2 in zip(leaves(g_shared), leaves(g_sh), leaves(g_src)):
            acc += np.asarray(g1) + np.asarray(g2)
    out = (g_stacked, g_shared, loss)
    _BY_STAGE_CACHE[key] = out
    return out


def _by_stage_at_every_p(cfg, spec, jax_sched, stacked, shared, side):
    return _by_stage_grads(cfg, spec, jax_sched.placement, stacked, shared, side)


@pytest.fixture
def arch(request, monkeypatch):
    monkeypatch.setattr(train_harness, "ARCH", request.param)
    monkeypatch.setattr(train_harness, "_jax_executor_grads", _by_stage_at_every_p)
    monkeypatch.setattr(train_harness, "_jax_by_stage_grads", _by_stage_grads)
    return request.param


@pytest.mark.parametrize("arch,name,p", CASES, indirect=["arch"],
                         ids=[f"{a}-{p}-{n}" for a, n, p in CASES])
def test_recurrent_pipelined_step_matches_jax(arch, name, p):
    g, _, _ = train_harness.check_pipelined_step(name, p, None, m=2)
    leaves = {"xlstm_350m": ("mfg", "si", "sf"), "recurrentgemma_9b": ("lam", "ra", "ri")}[arch]
    blocks = [kp for blk in g[0]["blocks"] for kp in blk]
    for k in leaves:
        assert any(k in kp and float(kp[k].abs().sum()) > 0 for kp in blocks), k


@pytest.mark.parametrize("arch", ARCHS, indirect=True)
def test_recurrent_w_routes_products(arch, wgrad_calls):
    p, m = 2, 3
    _, cfg_t, _, spec_t, _, (st_t, sh_t, side_t) = train_harness._setup(p, m)
    sched = train_harness.zb_h1(p, m)
    program = train_harness.tlm.build_program(cfg_t, spec_t, sched.placement)
    train_harness.PipelineExecutor(program, train_harness.compile_plan(sched)).build_grad_fn()(
        st_t, sh_t, side_t)
    kinds = program.chunks[0].block_kinds
    per_group = sum(LINEARS[k] for blk in kinds for k in blk)
    assert len(wgrad_calls) == per_group * p * m
    h = cfg_t.d_model
    narrow = [g for a, g in wgrad_calls if g[1] != h and a[1] == h
              and g[1] not in (cfg_t.d_ff, dict(cfg_t.extras).get("lru_width"))]
    if arch == "xlstm_350m":  # mfg and mig: one column a head
        assert {g[1] for g in narrow} == {cfg_t.n_heads}
        assert len(narrow) == 2 * sum(blk == ("mlstm",) for blk in kinds) * p * m


@pytest.mark.parametrize("arch", ARCHS, indirect=True)
def test_jax_written_checkpoint_trains_on_in_the_port(tmp_path, arch):
    """The JAX store writes the reduced model's parameters; the port
    restores them through ``checkpoint/store.py`` over weights of its own
    (another seed), and the restored model's pipelined zb-h1 step at p=2
    gives the JAX loss and gradients (the reference of the linear p=2
    cases above, cached).  The checkpoint holds the JAX init, not a trained
    state: the JAX driver cannot train xlstm (the scan-body split)."""
    from repro.checkpoint import store as jax_store

    from repro_torch.checkpoint import store

    p, m = 2, 2
    jax_sched, sched = train_harness.SCHEDULES["zb-h1"][1](p, m), train_harness.zb_h1(p, m)
    cfg_j, cfg_t, spec_j, spec_t, (st_j, sh_j, side_j), (_, _, side_t) = train_harness._setup(
        p, m, placement=jax_sched.placement)
    jax_store.save(str(tmp_path), 5, {"params": st_j, "shared": sh_j})
    own = train_harness.tlm.init_params(cfg_t, spec_t, sched.placement, seed=7, device="cpu")
    got, manifest = store.restore(str(tmp_path), 5, {"params": own[0], "shared": own[1]})
    assert manifest["step"] == 5 and got["params"] is own[0]  # restored in place
    g_j, sg_j, loss_j = _by_stage_grads(cfg_j, spec_j, jax_sched.placement, st_j, sh_j, side_j)
    program = train_harness.tlm.build_program(cfg_t, spec_t, sched.placement)
    g_t, sg_t, loss_t = train_harness.PipelineExecutor(
        program, train_harness.compile_plan(sched)).build_grad_fn()(
        got["params"], got["shared"], side_t)
    train_harness._close(loss_t, loss_j, train_harness.LOSS_TOL)
    train_harness._close_trees(g_t, g_j, train_harness.GRAD_TOL)
    train_harness._close_trees(sg_t, sg_j, train_harness.GRAD_TOL)


@pytest.mark.parametrize("arch_id,schedule", [("xlstm_350m", "zb-h1"),
                                              ("recurrentgemma_9b", "zb-v")])
def test_launcher_trains_the_recurrent_models(arch_id, schedule, capsys):
    from repro_torch.launch import train as launcher

    res = launcher.main(["--arch", arch_id, "--reduced", "--device", "cpu", "--pipe-size", "2",
                         "--m", "4", "--seq-len", "16", "--steps", "3", "--schedule", schedule])
    assert capsys.readouterr().out.splitlines()[-1].endswith(
        f"schedule={schedule} executor=eager")
    assert len(res.losses) == 3 and res.losses[-1] < res.losses[0]


@pytest.mark.parametrize("arch_id", ARCHS)
def test_slot_measurement_holds_no_graph(arch_id):
    """The measured fidelity's slot measurement leaves no tensor alive.  It
    saves every tensor of F's graph through a ``saved_tensors_hooks`` pack,
    and a branch of the graph that B never walks (an mLSTM memory update
    that no later chunk reads, once computed) then stays allocated with
    its saved tensors: no recurrent kind computes one."""
    import gc

    from repro_torch.configs import get_reduced
    from repro_torch.core.planner import HBMPlanner, stage_program_factory

    def live():
        gc.collect()
        return sum(o.numel() for o in gc.get_objects() if torch.is_tensor(o))

    cfg = get_reduced(arch_id)
    before = live()
    planner = HBMPlanner(cfg, p=2, m=4, microbatch=1, seq_len=64,
                         program_factory=stage_program_factory(cfg, 2, 4, 1, 64, "cpu"))
    planner.slot_bytes(1)
    assert live() == before
