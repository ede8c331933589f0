"""The port's examples (``src/repro_torch/examples/``) against the JAX package.

Each example of the JAX package's ``examples/`` has a counterpart that runs
as ``python -m repro_torch.examples.<name>``.  On the CPU, at the sizes
the tests can afford:

* ``quickstart``: the bubble rates and peak memories of 1F1B, ZB-H1, ZB-H2
  and ZB-V at p=4, m=8 and the searched schedule's bubble rate equal the
  JAX simulator's; part 3's pipelined loss is within 1e-5 of the JAX
  ``PipelineExecutor``'s under a one-device ``shard_map`` (the JAX
  example's computation), at the JAX ``init_params`` weights carried over
  with ``interop`` and the JAX side inputs; ``main`` prints the example's
  lines and ``OK``.
* ``serve_pipeline``: the prefill's and the eight decode steps' logits are
  within 1e-4 of the JAX package's, in f32, and the greedy tokens are
  equal.  The JAX serve step of the example needs a 4-device mesh, which
  fake devices give only before JAX starts; the reference is the JAX
  serving chunk (``models/serve.py::make_serve_chunk``) walked stage by
  stage, as ``tests/test_torch_serve_parity.py`` holds the port at p > 1.
* ``straggler_replan``: at p=4, m=8 (the example's p=16, m=64 took ~90 s
  on this CPU), the replanned and baseline costs and the rebalanced layers
  equal the JAX ``replan_for_stragglers`` / ``rebalance_layers`` results.
* ``train_100m``: its config equals the JAX example's ``gpt_100m()`` field
  for field; its ``main`` trains 2 steps on the CPU at a reduced width (the
  test replaces the config), and run again on its checkpoint directory
  it resumes (no step at the same ``--steps``, step 2 first with one
  more); asked for ``cuda`` without a card it raises instead of running
  on the CPU.

Tolerances: f32 losses within 1e-5 and serve logits within 1e-4, as the
train and serve parity tests hold them (the two frameworks sum in other
orders and use other exp/rsqrt implementations).
"""

import ast
import dataclasses
import pathlib

import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse)

import jax  # noqa: E402
import numpy as np  # noqa: E402
from jax.experimental.shard_map import shard_map  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402
from test_torch_serve_parity import _jax_serve_by_stage  # noqa: E402

from repro.configs import get_reduced as jax_get_reduced  # noqa: E402
from repro.core import schedules as jsched  # noqa: E402
from repro.core.executor import PipelineExecutor as JaxPipelineExecutor  # noqa: E402
from repro.core.schedules.ir import Placement as JaxPlacement  # noqa: E402
from repro.core.simulator import TimeModel as JaxTimeModel  # noqa: E402
from repro.core.simulator import simulate as jax_simulate  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.runtime import rebalance_layers as jax_rebalance  # noqa: E402
from repro.runtime import replan_for_stragglers as jax_replan  # noqa: E402

from repro_torch.examples import quickstart, serve_pipeline, straggler_replan  # noqa: E402
from repro_torch.examples import train_100m  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.models.lm import ArchConfig  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
LOSS_TOL, SERVE_TOL = 1e-5, 1e-4


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# --------------------------------------------------------------------- #
# quickstart
# --------------------------------------------------------------------- #
def test_quickstart_schedules_match_jax():
    p, m = quickstart.P, quickstart.M
    times = JaxTimeModel(t_f=1.0, t_b=1.0, t_w=1.0, t_comm=0.0)
    want = []
    for sched, tm in [(jsched.one_f_one_b(p, m), JaxTimeModel(1, 1, 1, 0, grouped_w=True)),
                      (jsched.zb_h1(p, m), times), (jsched.zb_h2(p, m), times),
                      (jsched.zb_v(p, m), times)]:
        mem = sched.memory_profile(1.0 / sched.n_chunks, 0.5 / sched.n_chunks)
        want.append((sched.name, jax_simulate(sched, tm).bubble_rate, mem.max_peak))
    assert quickstart.schedule_rows() == want
    profiled = JaxTimeModel(t_f=18.5, t_b=18.1, t_w=9.3, t_comm=0.6)
    assert quickstart.auto_bubble_rate() == jsched.search(p, m, profiled,
                                                           m_limit=2.0 * p).bubble_rate


def _jax_pipelined_loss():
    """The JAX example's part 3: its loss, weights and side inputs."""
    cfg = jax_get_reduced(quickstart.ARCH)
    s = quickstart.SPEC
    spec = jlm.RunSpec(p=s.p, n_chunks=s.n_chunks, microbatch=s.microbatch, seq_len=s.seq_len,
                       m=s.m)
    sched = jsched.zb_h2(1, 4)
    program = jlm.build_program(cfg, spec, sched.placement)
    grad_fn = JaxPipelineExecutor(program, jsched.compile_plan(sched),
                                  pipe_axis="pipe").build_grad_fn()
    stacked, shared = jlm.init_params(cfg, spec, sched.placement)
    side = jlm.side_inputs(cfg, spec)
    mesh = jax.make_mesh((1,), ("pipe",))
    fn = jax.jit(shard_map(
        lambda st, sh, sd: grad_fn(
            tuple(jax.tree_util.tree_map(lambda a: a[0], x) for x in st), sh, sd)[2],
        mesh=mesh,
        in_specs=(tuple(jax.tree_util.tree_map(lambda _: JP("pipe"), x) for x in stacked),
                  JP(), JP()),
        out_specs=JP(), check_rep=False))
    return float(fn(stacked, shared, side)), stacked, shared, side


def test_quickstart_loss_matches_jax():
    want, stacked, shared, side = _jax_pipelined_loss()
    params = params_from_numpy(_np(stacked), _np(shared), device="cpu")
    got = quickstart.pipelined_loss("cpu", params, _np(side))
    assert abs(float(got) - want) <= LOSS_TOL * abs(want), (float(got), want)


def test_quickstart_main_prints_the_example(capsys):
    loss = quickstart.main(["--device", "cpu"])
    out = capsys.readouterr().out
    for line in ("== 1F1B ==", "== ZB-H2 (zero bubble, 2x memory) ==",
                 "== ZB-V (zero bubble, 1F1B memory) ==", "auto ZB-2p schedule: bubble_rate=",
                 f"pipelined loss: {loss}"):
        assert line in out, line
    assert out.splitlines()[-1] == "OK" and np.isfinite(loss)


# --------------------------------------------------------------------- #
# serve_pipeline
# --------------------------------------------------------------------- #
def test_serve_pipeline_matches_jax():
    P_, M_, B_ = serve_pipeline.P_, serve_pipeline.M_, serve_pipeline.B_
    s = serve_pipeline.S_CTX - serve_pipeline.N_NEW
    cfg = jax_get_reduced(serve_pipeline.ARCH)
    spec = jlm.RunSpec(p=P_, n_chunks=1, microbatch=B_, seq_len=s, m=M_)
    stacked, shared = jlm.init_params(cfg, spec, JaxPlacement.linear(P_))
    tokens = np.asarray(jlm.side_inputs(cfg, spec)["tokens"])
    want = _jax_serve_by_stage(cfg, stacked, shared, tokens, serve_pipeline.N_NEW, P_)
    params = params_from_numpy(_np(stacked), _np(shared), device="cpu")
    got = serve_pipeline.generate("cpu", params, tokens, log=lambda *_: None)
    assert len(got["logits"]) == len(want) == serve_pipeline.N_NEW + 1
    for step, (g, w) in enumerate(zip(got["logits"], want)):
        np.testing.assert_allclose(g.numpy(), w, rtol=SERVE_TOL, atol=SERVE_TOL,
                                   err_msg=f"step {step}")
        np.testing.assert_array_equal(got["tokens"][..., step].numpy(), w.argmax(-1))


def test_serve_pipeline_main_prints_the_example(capsys):
    out_ = serve_pipeline.main(["--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith(f"prefill: {serve_pipeline.M_} groups x {serve_pipeline.B_} seqs")
    assert sum(line.startswith("decode step ") for line in out) == serve_pipeline.N_NEW
    assert out[-2] == f"generated: {out_['tokens'][0, 0].tolist()}" and out[-1] == "OK"
    vocab = jax_get_reduced(serve_pipeline.ARCH).vocab
    assert 0 <= int(out_["tokens"].min()) and int(out_["tokens"].max()) < vocab


# --------------------------------------------------------------------- #
# straggler_replan
# --------------------------------------------------------------------- #
def test_straggler_replan_matches_jax():
    p, m, g = 4, 8, 4
    lines = []
    got = straggler_replan.run(p, m, g, log=lines.append)
    slow_comm = JaxTimeModel(11.3, 11.25, 8.1, 0.38 * 6)
    _, new_cost, old_cost = jax_replan(p, m, slow_comm, (1.0,) * p, m_limit=2.0 * p)
    assert got["comm"] == (new_cost, old_cost)
    base = JaxTimeModel(11.3, 11.25, 8.1, 0.38)
    want = {}
    for slow_stage, factor in straggler_replan.SLOW:
        if slow_stage < p:
            scale = tuple(factor if s == slow_stage else 1.0 for s in range(p))
            layers, _, new, old = jax_rebalance(p, m, base, scale, layers_per_stage=g,
                                                m_limit=2.0 * p)
            want[(slow_stage, factor)] = (list(layers), new, old)
    assert got["rebalance"] == want and len(want) == 2
    assert lines[0].startswith("-- comm-jitter straggler") and len(lines) == 5


# --------------------------------------------------------------------- #
# train_100m
# --------------------------------------------------------------------- #
def _jax_gpt_100m():
    """The JAX example's ``gpt_100m()``, its function alone: the module
    itself sets ``XLA_FLAGS`` and edits ``sys.path`` when imported."""
    from repro.models.lm import ArchConfig as JaxArchConfig

    tree = ast.parse((ROOT / "examples" / "train_100m.py").read_text())
    (fn,) = [n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "gpt_100m"]
    space = {"ArchConfig": JaxArchConfig}
    exec(compile(ast.Module(body=[fn], type_ignores=[]), "train_100m.py", "exec"), space)
    return space["gpt_100m"]()


def test_train_100m_config_is_the_jax_one():
    want, got = _jax_gpt_100m(), train_100m.gpt_100m()
    assert isinstance(got, ArchConfig)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_train_100m_trains_and_resumes_on_the_cpu(tmp_path, monkeypatch, capsys):
    small = dataclasses.replace(train_100m.gpt_100m(), n_layers=4, d_model=64, n_heads=4,
                                n_kv_heads=4, d_ff=128, vocab=512)
    monkeypatch.setattr(train_100m, "gpt_100m", lambda: small)
    argv = ["--steps", "2", "--device", "cpu", "--ckpt-dir", str(tmp_path)]
    res = train_100m.main(argv)
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("model: gpt-100m") and out[-1] == "OK"
    assert "schedule=zb-h2 executor=eager" in out[-2]
    assert len(res.losses) == 2 and np.all(np.isfinite(res.losses))
    assert res.losses[1] < res.losses[0]
    # the same command again: the checkpoint is at step 2 already
    again = train_100m.main(argv)
    assert again.losses == []
    assert any(line.startswith("steps=0: the checkpoint in") for line in
               capsys.readouterr().out.splitlines())
    # one step more: it resumes at step 2
    more = train_100m.main(["--steps", "3", "--device", "cpu", "--ckpt-dir", str(tmp_path)])
    lines = capsys.readouterr().out.splitlines()
    assert len(more.losses) == 1 and lines[1].startswith("step 2: loss=")


def test_examples_raise_without_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA card"):
        train_100m.main(["--steps", "1", "--ckpt-dir", str(tmp_path)])
    assert not any(tmp_path.iterdir())
    for example in (quickstart, serve_pipeline):
        with pytest.raises(RuntimeError, match="CUDA card"):
            example.main([])
