"""The new dense models of the port, whole, against the JAX package: reduced
``gpt3_1_5b`` (multi-head attention, kv heads == q heads) and reduced
``gemma2_2b`` (alternating ``attn_local`` and ``attn`` blocks, period 2,
logit softcap), in float32 on the CPU.

* One pipelined training step at p=2, m=2 under ZB-H1 (one chunk a stage)
  and ZB-V (two chunks on the V placement): gpt3 under both, and again with
  an odd vocabulary (251); gemma2 under ZB-H1 at its reduced depth (stage 1
  all padding) and under ZB-V at 8 layers (whole periods in every group):
  loss within 1e-5 and every gradient leaf within 1e-4 of
  ``jax.value_and_grad`` of the JAX groups walked in depth order
  (``test_torch_train_parity.py``'s reference at p > 1).
* Serving at p=2: prefill of 16 tokens (two whole windows of the reduced
  gemma2, where the JAX ring is right) and 3 decode steps, logits within
  1e-4 of the JAX ``make_serve_chunk`` applied stage by stage, greedy
  tokens equal.
* ``chip_smoke.py``'s ``relay_to_placement`` lays a padded model (gpt3 at
  7 layers: 8 slots at p=2 in either layout) onto the V placement, masks
  included: zb-v's step-0 loss and gradient equal zb-h1's bit for bit.
* The launcher's default arch is ``gpt3_1_5b``: a reduced CPU run without
  ``--arch`` trains it, its losses fall.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_reduced as jax_get_reduced  # noqa: E402
from repro.core.schedules import zb_h1 as jax_zb_h1  # noqa: E402
from repro.core.schedules import zb_v as jax_zb_v  # noqa: E402
from repro.core.schedules.ir import Placement as JaxPlacement  # noqa: E402
from repro.models import lm as jlm  # noqa: E402

from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.core.executor import PipelineExecutor  # noqa: E402
from repro_torch.core.schedules import compile_plan, zb_h1, zb_v  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.launch import train as launcher  # noqa: E402
from repro_torch.launch.serve import serve  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.core.schedules.ir import Placement  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402
from test_torch_serve_parity import _jax_serve_by_stage  # noqa: E402
from test_torch_train_parity import _chip_smoke, _jax_by_stage_grads  # noqa: E402

LOSS_TOL, GRAD_TOL, SERVE_TOL = 1e-5, 1e-4, 1e-4
SCHEDULES = {"zb-h1": (zb_h1, jax_zb_h1), "zb-v": (zb_v, jax_zb_v)}
# (arch, schedule, replaced fields of the reduced config)
STEP_CASES = [
    ("gpt3_1_5b", "zb-h1", {}),
    ("gpt3_1_5b", "zb-v", {}),
    ("gpt3_1_5b", "zb-h1", {"vocab": 251}),
    ("gemma2_2b", "zb-h1", {}),
    ("gemma2_2b", "zb-v", {"n_layers": 8}),
]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().float().cpu().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _configs(arch, **replace):
    return (dataclasses.replace(jax_get_reduced(arch), **replace),
            dataclasses.replace(get_reduced(arch), **replace))


@pytest.mark.parametrize(
    "arch,name,replace", STEP_CASES,
    ids=[f"{a}-{n}" + "".join(f"-{k}{v}" for k, v in r.items()) for a, n, r in STEP_CASES])
def test_pipelined_step_matches_jax(arch, name, replace):
    p, m, b, s = 2, 2, 2, 16
    port_sched, jax_sched = SCHEDULES[name][0](p, m), SCHEDULES[name][1](p, m)
    cfg_j, cfg_t = _configs(arch, **replace)
    C = jax_sched.n_chunks
    spec_j = jlm.RunSpec(p=p, n_chunks=C, microbatch=b, seq_len=s, m=m)
    spec_t = tlm.RunSpec(p=p, n_chunks=C, microbatch=b, seq_len=s, m=m)
    stacked_j, shared_j = jlm.init_params(cfg_j, spec_j, jax_sched.placement,
                                          key=jax.random.PRNGKey(0))
    stacked_t, shared_t = params_from_numpy(_np(stacked_j), _np(shared_j), device="cpu")
    side_np = tlm.side_inputs(cfg_t, spec_t, seed=100)
    side_j = {k: jnp.asarray(v, jnp.int32) for k, v in side_np.items()}
    side_t = {k: torch.as_tensor(v, dtype=torch.long) for k, v in side_np.items()}

    g_j, sg_j, loss_j = _jax_by_stage_grads(cfg_j, spec_j, jax_sched.placement, stacked_j,
                                            shared_j, side_j)
    program = tlm.build_program(cfg_t, spec_t, port_sched.placement)
    g_t, sg_t, loss_t = PipelineExecutor(program, compile_plan(port_sched)).build_grad_fn()(
        stacked_t, shared_t, side_t)
    _close(loss_t, loss_j, LOSS_TOL)
    got, want = tree_leaves((g_t, sg_t)), jax.tree_util.tree_leaves((g_j, sg_j))
    assert len(got) == len(want)
    for a, w in zip(got, want):
        assert tuple(a.shape) == tuple(w.shape) and a.dtype == torch.float32
        _close(a, w, GRAD_TOL)
    if arch == "gemma2_2b":  # both kinds of attention ran, each in its own blocks
        kinds = [k for blk in program.chunks[0].block_kinds for k in blk]
        assert kinds.count("attn_local") == kinds.count("attn") > 0


@pytest.mark.parametrize("arch", ["gpt3_1_5b", "gemma2_2b"])
def test_serve_matches_jax_f32(arch):
    p, m, b, s, new = 2, 2, 2, 16, 3
    cfg_j, cfg_t = _configs(arch)
    if arch == "gemma2_2b":
        assert s % dict(cfg_t.extras)["window"] == 0  # where the JAX ring is right
    spec = jlm.RunSpec(p=p, n_chunks=1, microbatch=b, seq_len=s, m=m)
    stacked_j, shared_j = jlm.init_params(cfg_j, spec, JaxPlacement.linear(p))
    stacked_t, shared_t = params_from_numpy(_np(stacked_j), _np(shared_j), device="cpu")
    prompts = np.random.default_rng(1).integers(0, cfg_t.vocab, (m, b, s))
    ref = _jax_serve_by_stage(cfg_j, stacked_j, shared_j, prompts, new, p)
    res = serve(cfg_t, stacked_t, shared_t, prompts, p=p, new_tokens=new)
    assert len(res.logits) == len(ref) == new + 1
    for i, (got, want) in enumerate(zip(res.logits, ref)):
        assert tuple(got.shape) == want.shape == (m, b, cfg_t.vocab), i
        _close(got, want, SERVE_TOL)
        np.testing.assert_array_equal(res.tokens[..., i].numpy(), want.argmax(-1))


def test_launcher_trains_gpt3_1_5b_by_default(capsys):
    res = launcher.main(["--reduced", "--device", "cpu", "--pipe-size", "2", "--m", "4",
                         "--seq-len", "16", "--steps", "3", "--schedule", "zb-h1"])
    out = capsys.readouterr().out
    assert out.splitlines()[-1].endswith("schedule=zb-h1 executor=eager")
    assert len(res.losses) == 3 and res.losses[-1] < res.losses[0]
    # the reduced gpt3's blocks: 4 kv heads of 12 (internlm2's: 2), d_ff 192 (96)
    attn, mlp = res.state["params"][0]["blocks"][0]
    assert tuple(attn["wk"].shape[1:]) == (48, 48) and tuple(mlp["wu"].shape[1:]) == (48, 192)


def test_v_relay_carries_padded_slots():
    cs = _chip_smoke()
    cfg = dataclasses.replace(get_reduced("gpt3_1_5b"), n_layers=7)
    p, m, b, s = 2, 4, 2, 16
    lin, v = zb_h1(p, m), zb_v(p, m)
    spec = tlm.RunSpec(p=p, n_chunks=1, microbatch=b, seq_len=s, m=m)
    v_spec = dataclasses.replace(spec, n_chunks=2)
    stacked, shared = tlm.init_params(cfg, spec, Placement.linear(p), seed=0, device="cpu")
    v_stacked = cs.relay_to_placement(cfg, stacked, v.placement)
    masks = tlm.group_masks(cfg, p, 2, v.placement)
    assert masks.sum() == cfg.n_layers < masks.size
    for c in range(2):
        np.testing.assert_array_equal(v_stacked[c]["mask"].numpy(), masks[:, c])
    side = {k: torch.as_tensor(a, dtype=torch.long)
            for k, a in tlm.side_inputs(cfg, spec, seed=3).items()}
    g, sg, loss = PipelineExecutor(tlm.build_program(cfg, spec, lin.placement),
                                   compile_plan(lin)).build_grad_fn()(stacked, shared, side)
    gv, sgv, loss_v = PipelineExecutor(tlm.build_program(cfg, v_spec, v.placement),
                                       compile_plan(v)).build_grad_fn()(v_stacked, shared, side)
    assert float(loss_v) == float(loss)
    for a, w in zip(tree_leaves(sgv), tree_leaves(sg)):
        assert torch.equal(a, w)
    for (st, bi), (c, vs, vbi) in cs._layer_map(cfg, v.placement):
        got = tree_map(lambda a: a[vs], gv[c]["blocks"][vbi])
        want = tree_map(lambda a: a[st], g[0]["blocks"][bi])
        for a, w in zip(tree_leaves(got), tree_leaves(want)):
            assert torch.equal(a, w), (st, bi)
