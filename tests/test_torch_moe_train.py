"""Reduced ``qwen2_moe_a2_7b`` (attn + moe blocks) trained by the port
against the JAX package, in float32 on the CPU.

* One pipelined step at p in {1, 2} under all eight schedules of the
  launcher: loss within 1e-5 and every gradient leaf (the float32 router,
  the (E, H, F) expert stacks, the shared experts) within 1e-4, through
  ``test_torch_train_parity.py``'s harness with its arch set to the moe
  model: the JAX ``PipelineExecutor`` at p=1, ``jax.value_and_grad`` of the
  groups in depth order at p=2.  1F1B, ZB-H1 and ZB-H2 at the reduced
  depth (2 layers); the V schedules, ZB-1p and ZB-2p at ``n_layers = 2p``.
* A checkpoint that the JAX driver wrote for the moe model (params and
  AdamW state after 3 steps) continues in the port: the next loss within
  1e-5 (``test_torch_driver.py``'s harness with its arch set likewise).
* W of one step adds the router's and the shared experts' products
  through ``wgrad_accum`` (4 a moe block) and the attention's (4), never
  the expert stacks'.
* The training launcher takes ``--arch qwen2_moe_a2_7b``: a reduced CPU
  run under zb-v, its losses fall.
"""

import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse)

import test_torch_driver as driver_harness  # noqa: E402
import test_torch_train_parity as train_harness  # noqa: E402
from test_torch_train_parity import wgrad_calls  # noqa: E402,F401

MOE = "qwen2_moe_a2_7b"
LINEAR = ("1f1b", "zb-h1", "zb-h2")
CASES = [(n, p, None if n in LINEAR else 2 * p) for n in train_harness.SCHEDULES for p in (1, 2)]


@pytest.fixture
def moe_arch(monkeypatch):
    monkeypatch.setattr(train_harness, "ARCH", MOE)
    monkeypatch.setattr(driver_harness, "ARCH", MOE)


@pytest.mark.parametrize("name,p,n_layers", CASES,
                         ids=[f"{p}-{n}" + ("" if nl is None else f"-{nl}L")
                              for n, p, nl in CASES])
def test_moe_pipelined_step_matches_jax(name, p, n_layers, moe_arch):
    g, _, _ = train_harness.check_pipelined_step(name, p, n_layers)
    moe = g[0]["blocks"][0][1]
    assert moe["router"].dtype == torch.float32 and moe["wu"].dim() == 4  # (p, E, H, F)
    assert all(float(moe[k].abs().sum()) > 0 for k in ("router", "wu", "wg", "wd", "swu"))


def test_moe_w_routes_products(moe_arch, wgrad_calls):
    """One zb-h1 step at p=2, m=3: 8 wgrad_accum calls a block (wq wk wv wo,
    router swu swg swd), none with a batch of experts."""
    p, m = 2, 3
    _, cfg_t, _, spec_t, _, (st_t, sh_t, side_t) = train_harness._setup(p, m)
    sched = train_harness.zb_h1(p, m)
    program = train_harness.tlm.build_program(cfg_t, spec_t, sched.placement)
    train_harness.PipelineExecutor(program, train_harness.compile_plan(sched)).build_grad_fn()(
        st_t, sh_t, side_t)
    blocks = len(program.chunks[0].mods)
    assert len(wgrad_calls) == 8 * blocks * p * m
    ex = dict(cfg_t.extras)
    assert sum(1 for a, g in wgrad_calls if g == (a[0], ex["n_experts"])) \
        == blocks * p * m  # the router, (N, H) x (N, E)
    f_shared = ex["moe_d_ff"] * ex["n_shared_experts"]
    assert {len(a) for a, _ in wgrad_calls} == {2}
    assert {a[1] for a, _ in wgrad_calls} == {cfg_t.d_model, f_shared}


def test_jax_moe_checkpoint_continues_in_the_port(tmp_path, moe_arch):
    driver_harness.test_jax_checkpoint_continues_in_the_port(tmp_path)


def test_launcher_trains_the_moe_model(capsys):
    from repro_torch.launch import train as launcher

    res = launcher.main(["--arch", MOE, "--reduced", "--device", "cpu", "--pipe-size", "2",
                         "--m", "4", "--seq-len", "16", "--steps", "3", "--schedule", "zb-v"])
    assert capsys.readouterr().out.splitlines()[-1].endswith("schedule=zb-v executor=eager")
    assert len(res.losses) == 3 and res.losses[-1] < res.losses[0]
    moe = res.state["params"][0]["blocks"][0][1]
    assert moe["router"].dtype == torch.float32 and moe["wu"].dim() == 4
