"""Reduced ``deepseek_v3_671b`` (mla + moe blocks) trained by the port
against the JAX package, in float32 on the CPU.

* One pipelined step at p in {1, 2} under all eight schedules of the
  launcher: loss within 1e-5 and every gradient leaf (the six MLA
  weights, the float32 router, the expert stacks, the shared expert)
  within 1e-4, through ``test_torch_train_parity.py``'s harness with its
  arch set to the deepseek model: the JAX ``PipelineExecutor`` at p=1,
  ``jax.value_and_grad`` of the groups in depth order at p=2.  1F1B, ZB-H1
  and ZB-H2 at the reduced depth (2 layers); the V schedules, ZB-1p and
  ZB-2p at ``n_layers = 2p``.
* W of one step defers all six MLA products of each block to
  ``wgrad_accum`` (``xin@wdq``, ``@wuq``, ``xin@wdkv``, ``c@wuk``,
  ``c@wuv``, ``o@wo``), and the moe kind's four (router, 3 shared), never
  the expert stacks': 10 calls a block, microbatch and stage.
* The training launcher takes ``--arch deepseek_v3_671b``: a reduced CPU
  run under zb-h1, its losses fall.
"""

import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse)

import test_torch_train_parity as train_harness  # noqa: E402
from test_torch_train_parity import wgrad_calls  # noqa: E402,F401

ARCH = "deepseek_v3_671b"
LINEAR = ("1f1b", "zb-h1", "zb-h2")
CASES = [(n, p, None if n in LINEAR else 2 * p) for n in train_harness.SCHEDULES for p in (1, 2)]
MLA_LEAVES = ("wdq", "wuq", "wdkv", "wuk", "wuv", "wo")


@pytest.fixture
def mla_arch(monkeypatch):
    monkeypatch.setattr(train_harness, "ARCH", ARCH)


@pytest.mark.parametrize("name,p,n_layers", CASES,
                         ids=[f"{p}-{n}" + ("" if nl is None else f"-{nl}L")
                              for n, p, nl in CASES])
def test_mla_pipelined_step_matches_jax(name, p, n_layers, mla_arch):
    g, _, _ = train_harness.check_pipelined_step(name, p, n_layers)
    mla, moe = g[0]["blocks"][0]
    assert all(float(mla[k].abs().sum()) > 0 for k in MLA_LEAVES)
    assert moe["router"].dtype == torch.float32 and moe["wu"].dim() == 4  # (p, E, H, F)


def test_mla_w_defers_all_six_products(mla_arch, wgrad_calls):
    """One zb-h1 step at p=2, m=3: 10 wgrad_accum calls a block (the six
    MLA products, then router swu swg swd), none with a batch of experts."""
    p, m = 2, 3
    _, cfg_t, _, spec_t, _, (st_t, sh_t, side_t) = train_harness._setup(p, m)
    sched = train_harness.zb_h1(p, m)
    program = train_harness.tlm.build_program(cfg_t, spec_t, sched.placement)
    train_harness.PipelineExecutor(program, train_harness.compile_plan(sched)).build_grad_fn()(
        st_t, sh_t, side_t)
    blocks = len(program.chunks[0].mods)
    assert len(wgrad_calls) == 10 * blocks * p * m
    ex = dict(cfg_t.extras)
    h, hq, dh = cfg_t.d_model, cfg_t.n_heads, cfg_t.head_dim
    d_q, d_kv, d_r = ex["q_lora_rank"], ex["kv_lora_rank"], ex["qk_rope_head_dim"]
    mla = [(h, d_q), (d_q, hq * (dh + d_r)), (h, d_kv + d_r), (d_kv, hq * dh), (d_kv, hq * dh),
           (hq * dh, h)]
    moe = [(h, ex["n_experts"])] + [(h, ex["moe_d_ff"])] * 2 + [(ex["moe_d_ff"], h)]
    shapes = [(a[1], g[1]) for a, g in wgrad_calls]
    assert all(shapes[i:i + 10] == mla + moe for i in range(0, len(shapes), 10))
    assert {len(a) for a, _ in wgrad_calls} == {2}


def test_launcher_trains_the_mla_model(capsys):
    from repro_torch.launch import train as launcher

    res = launcher.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--pipe-size", "2",
                         "--m", "4", "--seq-len", "16", "--steps", "3", "--schedule", "zb-h1"])
    assert capsys.readouterr().out.splitlines()[-1].endswith("schedule=zb-h1 executor=eager")
    assert len(res.losses) == 3 and res.losses[-1] < res.losses[0]
    mla = res.state["params"][0]["blocks"][0][0]
    assert all(mla[k].dim() == 3 for k in MLA_LEAVES)  # (p, in, out)
