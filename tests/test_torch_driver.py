"""The port's checkpoint store and fault-tolerant driver
(``repro_torch.checkpoint``, ``repro_torch.runtime``), against the JAX
package's and on their own.

* A checkpoint round trip restores every leaf bit for bit (bf16, fp32,
  int32, the AdamW NamedTuple's fields), on the layout and leaf keys the
  JAX store writes; a JAX-written bf16 leaf reads bit for bit.
* A checkpoint that the JAX driver wrote (reduced internlm2, params and
  AdamW state after 3 steps) restores into the port, and the port's next
  step gives the JAX driver's next loss within 1e-5.
* A failure at step 4 under the port's driver, restored from the step-3
  checkpoint, ends bit for bit where an uninterrupted run ends, as
  ``tests/test_fault_tolerance.py::test_failure_recovery_exact`` checks for
  JAX; ``init_state()`` hands back untouched weights after steps have run.
* ``replan_for_stragglers``, ``rebalance_layers``, ``replan_under_budget``
  and ``reshard_stages`` give the JAX package's results.
* The launcher: ``--memory-budget-mb`` prints the planner's choice and
  breakdown and trains it; a tiny budget raises naming the binding term;
  ``--ckpt-dir`` resumes from the newest checkpoint.
"""

import os
import shutil

import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.checkpoint import store as jax_store  # noqa: E402
from repro.configs import get_reduced as jax_get_reduced  # noqa: E402
from repro.core.schedules import compile_plan as jax_compile_plan  # noqa: E402
from repro.core.schedules import zb_h1 as jax_zb_h1  # noqa: E402
from repro.core.simulator import TimeModel as JaxTimeModel  # noqa: E402
from repro.launch.mesh import AxisBinding  # noqa: E402
from repro.launch.steps import TrainStepConfig as JaxTrainStepConfig  # noqa: E402
from repro.launch.steps import build_train_step as jax_build_train_step  # noqa: E402
from repro.launch.train import side_from_batch as jax_side_from_batch  # noqa: E402
from repro.models.lm import RunSpec as JaxRunSpec  # noqa: E402
from repro.models.lm import init_params as jax_init_params  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.runtime import driver as jax_driver  # noqa: E402

from repro_torch.checkpoint import store  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.core.schedules import compile_plan, zb_h1  # noqa: E402
from repro_torch.core.simulator import TimeModel  # noqa: E402
from repro_torch.data import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.interop import adamw_from_numpy, params_from_numpy  # noqa: E402
from repro_torch.launch import train as launcher  # noqa: E402
from repro_torch.launch.steps import TrainStepConfig, build_train_step  # noqa: E402
from repro_torch.launch.train import init_state, make_data_at, make_step_fn  # noqa: E402
from repro_torch.models.lm import RunSpec, init_params  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.runtime import DriverConfig, TrainDriver  # noqa: E402
from repro_torch.runtime import driver as port_driver  # noqa: E402
from repro_torch.tree import keyed_leaves, tree_leaves  # noqa: E402
from test_torch_train_plan import _no_stored_plans  # noqa: E402,F401

ARCH = "internlm2_1_8b"
NEXT_LOSS_RTOL = 1e-5
P, M, B, S = 1, 4, 2, 16  # the JAX fault-tolerance test's run


def _port_driver(ckpt_dir, every=3, seed=0):
    cfg = get_reduced(ARCH)
    sched = zb_h1(P, M)
    spec = RunSpec(p=P, n_chunks=1, microbatch=B, seq_len=S, m=M)
    step, _ = build_train_step(cfg, spec, compile_plan(sched), sched.placement, TrainStepConfig())
    data = SyntheticLM(DataConfig(global_batch=M * B, seq_len=S, vocab=cfg.vocab))

    def fresh():
        return init_state(*init_params(cfg, spec, sched.placement, seed=seed, device="cpu"))

    return TrainDriver(DriverConfig(ckpt_dir=ckpt_dir, ckpt_every=every, max_retries=2),
                       make_step_fn(step), fresh, make_data_at(data, spec, "cpu", cfg))


def _jax_driver(ckpt_dir, every=3):
    cfg = jax_get_reduced(ARCH)
    sched = jax_zb_h1(P, M)
    spec = JaxRunSpec(p=P, n_chunks=1, microbatch=B, seq_len=S, m=M)
    make, _ = jax_build_train_step(cfg, spec, jax_compile_plan(sched), sched.placement,
                                   jax.make_mesh((P,), ("data",)),
                                   AxisBinding(pipe="data", tp=None, dp=None),
                                   JaxTrainStepConfig(donate=False))
    from repro.data import DataConfig as JaxDataConfig, SyntheticLM as JaxSyntheticLM

    data = JaxSyntheticLM(JaxDataConfig(global_batch=M * B, seq_len=S, vocab=cfg.vocab))
    step = make(jax_side_from_batch(data.batch_at(0), spec, cfg=cfg))

    def fresh():
        stacked, shared = jax_init_params(cfg, spec, sched.placement)
        z = lambda t: jax.tree_util.tree_map(lambda a: jnp.zeros(a.shape, jnp.float32), t)  # noqa
        return dict(params=stacked, shared=shared,
                    opt=jadamw.AdamWState(jnp.zeros((), jnp.int32), z(stacked), z(stacked)),
                    shared_opt=jadamw.AdamWState(jnp.zeros((), jnp.int32), z(shared), z(shared)))

    def step_fn(state, batch):
        out = step(state["params"], state["shared"], state["opt"], state["shared_opt"],
                   jax_side_from_batch(batch, spec, cfg=cfg))
        return dict(zip(("params", "shared", "opt", "shared_opt"), out[:4])), out[4]

    return jax_driver.TrainDriver(jax_driver.DriverConfig(ckpt_dir=ckpt_dir, ckpt_every=every),
                                  step_fn, fresh, data.batch_at)


def test_checkpoint_round_trip(tmp_path):
    g = torch.Generator().manual_seed(0)
    state = {
        "params": ({"mask": torch.ones(2, 3), "blocks": ((
            {"wq": torch.randn(2, 4, 4, generator=g).to(torch.bfloat16)},),)},),
        "opt": adamw.AdamWState(torch.tensor(7, dtype=torch.int32),
                                {"w": torch.randn(3, generator=g)}, {"w": torch.rand(3, generator=g)}),
    }
    store.save(str(tmp_path), 5, state, meta={"p": 2})
    assert store.latest_step(str(tmp_path)) == 5 and store.latest_step(None) is None
    proto = {
        "params": ({"mask": torch.zeros(2, 3), "blocks": ((
            {"wq": torch.zeros(2, 4, 4, dtype=torch.bfloat16)},),)},),
        "opt": adamw.AdamWState(torch.tensor(0, dtype=torch.int32), {"w": torch.zeros(3)},
                                {"w": torch.zeros(3)}),
    }
    got, manifest = store.restore(str(tmp_path), 5, proto)
    assert got is proto and manifest["step"] == 5 and manifest["meta"] == {"p": 2}
    assert manifest["dtypes"]["params"] == {"[0]['blocks'][0][0]['wq']": "bfloat16"}
    assert manifest["index"]["opt"] == [".m['w']", ".t", ".v['w']"]
    for (ka, a), (kb, b) in zip(keyed_leaves(got), keyed_leaves(state)):
        assert ka == kb and a.dtype == b.dtype and torch.equal(a, b), ka
    # the JAX store's keys for the same structure, and its bf16 leaves bit for bit
    jax_state = {"opt": jadamw.AdamWState(jnp.int32(7), {"w": jnp.arange(3.0)}, {"w": jnp.ones(3)}),
                 "params": {"wq": jnp.asarray(np.linspace(-3, 3, 8), jnp.bfloat16)}}
    jax_store.save(str(tmp_path / "j"), 1, jax_state)
    proto = {"opt": adamw.AdamWState(torch.tensor(0, dtype=torch.int32), {"w": torch.zeros(3)},
                                     {"w": torch.zeros(3)}),
             "params": {"wq": torch.zeros(8, dtype=torch.bfloat16)}}
    got, _ = store.restore(str(tmp_path / "j"), 1, proto)
    want = torch.from_numpy(np.array(jax_state["params"]["wq"]).view(np.int16)).view(torch.bfloat16)
    assert torch.equal(got["params"]["wq"], want)
    assert int(got["opt"].t) == 7 and torch.equal(got["opt"].m["w"], torch.arange(3.0))


def test_jax_checkpoint_continues_in_the_port(tmp_path):
    d, d_jax = str(tmp_path / "a"), str(tmp_path / "b")
    jd = _jax_driver(d)
    jd.run(3)  # checkpoint at step 3
    assert jax_store.latest_step(d) == 3
    shutil.copytree(d, d_jax)
    # the port's fresh state (other random weights) overwritten by JAX's
    pd = _port_driver(d, every=100)
    restored, step = pd._restore_or_init()
    assert step == 3 and int(restored["opt"].t) == 3
    _, port_log = pd.run(4)  # restores step 3, runs step 3
    jd.cfg.ckpt_dir = d_jax
    _, jax_log = jd.run(4)
    assert [k for k, _ in port_log] == [k for k, _ in jax_log] == [3]
    want = float(jax_log[0][1]["loss"])
    assert port_log[0][1]["loss"] == pytest.approx(want, rel=NEXT_LOSS_RTOL)
    # the carry-over helpers read the same numbers as the store
    st = jax.tree_util.tree_map(np.asarray, jax_store.restore(d_jax, 3, jd.init_state())[0])
    stacked, shared = params_from_numpy(st["params"], st["shared"], device="cpu")
    opt = adamw_from_numpy(st["opt"], device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(
        tree_leaves((stacked, shared, opt)),
        tree_leaves((restored["params"], restored["shared"], restored["opt"]))))


def test_failure_recovery_exact(tmp_path):
    clean = _port_driver(str(tmp_path / "a"))
    state_clean, log_clean = clean.run(6)
    crashed = {"done": False}

    def fail_hook(step):
        if step == 4 and not crashed["done"]:
            crashed["done"] = True
            raise RuntimeError("simulated node failure")

    faulty = _port_driver(str(tmp_path / "b"))
    state_faulty, log_faulty = faulty.run(6, fail_hook=fail_hook)
    assert crashed["done"]
    assert [k for k, _ in log_faulty] == [0, 1, 2, 3, 3, 4, 5]  # step 3 replayed from step 3's ckpt
    for a, b in zip(tree_leaves(state_clean), tree_leaves(state_faulty)):
        assert torch.equal(a, b)
    clean_by_step = dict(log_clean)
    for k, met in log_faulty:
        assert met == clean_by_step[k]
    assert len(faulty.step_times) == 7 and len(faulty.save_times) == 2  # at steps 3 and 6
    assert sorted(os.listdir(tmp_path / "b")) == ["step_00000003", "step_00000006"]


def test_init_state_is_fresh_after_steps():
    driver = _port_driver(None)
    before = [t.clone() for t in tree_leaves(driver.init_state())]
    state, log = driver.run(2)
    assert [k for k, _ in log] == [0, 1] and int(state["opt"].t) == 2
    again = driver.init_state()
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(again), before))
    assert int(again["opt"].t) == 0
    assert not torch.equal(state["shared"]["embed"], again["shared"]["embed"])


def test_straggler_replanning_matches_jax():
    p, m = 4, 8
    scale = (1.0, 1.0, 1.4, 1.0)
    mine = port_driver.replan_for_stragglers(p, m, TimeModel(1.0, 1.0, 1.0, 0.1), scale, 2.0 * p)
    ref = jax_driver.replan_for_stragglers(p, m, JaxTimeModel(1.0, 1.0, 1.0, 0.1), scale, 2.0 * p)
    assert (mine[0].name, mine[1], mine[2]) == (ref[0].name, ref[1], ref[2])
    assert mine[1] <= mine[2]
    scale = (1.0, 1.6, 1.0, 1.0)
    mine = port_driver.rebalance_layers(p, m, TimeModel.unit(), scale, 6, 2.0 * p)
    ref = jax_driver.rebalance_layers(p, m, JaxTimeModel.unit(), scale, 6, 2.0 * p)
    assert (mine[0], mine[1].name, mine[2], mine[3]) == (ref[0], ref[1].name, ref[2], ref[3])
    assert mine[0] != [6] * p and mine[2] < mine[3]


def test_replan_under_budget_matches_jax():
    cfg, cfg_j = get_reduced(ARCH), jax_get_reduced(ARCH)
    sched, rep = port_driver.replan_under_budget(cfg, 4, 8, 2, 32, 1.5 * 2**20, temp_bytes=0.0)
    ref, rep_j = jax_driver.replan_under_budget(cfg_j, 4, 8, 2, 32, 1.5 * 2**20,
                                                xla_temp_bytes=0.0)
    assert (sched.name, rep.chosen.cost) == (ref.name, rep_j.chosen.cost)
    errors = []
    for mod, kw in ((port_driver, {"temp_bytes": 0.0}), (jax_driver, {"xla_temp_bytes": 0.0})):
        with pytest.raises(RuntimeError, match="binding term: ") as e:
            mod.replan_under_budget(cfg if mod is port_driver else cfg_j, 4, 8, 2, 32,
                                    0.1 * 2**20, **kw)
        errors.append(str(e.value).split("binding term: ")[1].split()[0])
    assert errors[0] == errors[1] == "act"


def test_reshard_stages_matches_jax():
    leaf = np.arange(4 * 6 * 5.0).reshape(4, 6, 5)
    for p_new in (2, 4, 8):
        got = store.reshard_stages({"w": torch.from_numpy(leaf), "g": torch.ones(3)}, 4, p_new)
        want = jax_store.reshard_stages({"w": leaf, "g": np.ones(3)}, 4, p_new)
        np.testing.assert_array_equal(got["w"].numpy(), want["w"])
        np.testing.assert_array_equal(got["g"].numpy(), want["g"])
    with pytest.raises(ValueError):
        store.reshard_stages({"w": torch.from_numpy(leaf)}, 4, 7)


LAUNCH = ["--arch", "internlm2_1_8b", "--reduced", "--device", "cpu", "--pipe-size", "4", "--m", "8",
          "--seq-len", "32"]


def test_launcher_plans_under_a_budget_and_resumes(tmp_path, capsys):
    ckpt = str(tmp_path / "ck")
    res = launcher.main(LAUNCH + ["--steps", "3", "--memory-budget-mb", "4", "--ckpt-dir", ckpt])
    out = capsys.readouterr().out
    chosen = res.schedule.name
    assert f"HBM planner: budget 4 MiB -> {chosen}" in out
    for term in ("params", "optim", "act", "wctx", "sink", "temp", "total"):
        assert f"\n  {term} " in out
    assert "(temp = accumulators " in out and "not priced" not in out
    assert "priced on one card holding all 4 stages: " in out
    assert f"schedule={chosen} executor=eager" in out and len(res.losses) == 3
    assert store.latest_step(ckpt) == 3
    proto = init_state(*init_params(get_reduced(ARCH), RunSpec(p=4, n_chunks=res.schedule.n_chunks,
                                                              microbatch=2, seq_len=32, m=8),
                                    res.schedule.placement, seed=1, device="cpu"))
    got, _ = store.restore(ckpt, 3, proto)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(got), tree_leaves(res.state)))
    more = launcher.main(LAUNCH + ["--steps", "4", "--memory-budget-mb", "4", "--ckpt-dir", ckpt])
    assert len(more.losses) == 1 and "step 3:" in capsys.readouterr().out


def test_launcher_tiny_budget_names_the_binding_term():
    with pytest.raises(RuntimeError, match="binding term: "):
        launcher.main(LAUNCH + ["--steps", "1", "--memory-budget-mb", "0.5"])


@pytest.mark.parametrize("fn", ["build_everything", "init_params"])
def test_entry_points_need_a_device(fn):
    """Neither builds on the CPU unless the caller names it: a call without
    ``device`` raises before any work."""
    cfg = get_reduced(ARCH)
    sched = zb_h1(P, M)
    spec = RunSpec(p=P, n_chunks=1, microbatch=B, seq_len=S, m=M)
    with pytest.raises(TypeError, match="device"):
        if fn == "init_params":
            init_params(cfg, spec, sched.placement, seed=0)
        else:
            launcher.build_everything(ARCH, True, P, "zb-h1", B, S, M, TrainStepConfig())
