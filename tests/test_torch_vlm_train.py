"""Reduced ``llava_next_mistral_7b`` (attn + mlp blocks behind the patch
front) trained by the port against the JAX package, in float32 on the CPU.

* One pipelined step at p in {1, 2} under all eight schedules of the
  launcher: loss within 1e-5 and every gradient leaf (``front_proj`` and
  the embedding included) within 1e-4, through
  ``test_torch_train_parity.py``'s harness with its arch set to the vlm
  (random patches from ``side_inputs``): the JAX ``PipelineExecutor`` at
  p=1, ``jax.value_and_grad`` of the groups in depth order at p=2.
  1F1B, ZB-H1 and ZB-H2 at the reduced depth (2 layers); the V
  schedules, ZB-1p and ZB-2p at ``n_layers = 2p``.
* W of one step: 7 ``wgrad_accum`` calls a block and one for
  ``front_proj`` a microbatch, (b n_patches, frontend_dim) x (b
  n_patches, d).
* The training launcher takes ``--arch llava_next_mistral_7b`` (zero
  patches, as the JAX launcher feeds): a reduced CPU run under zb-v, its
  losses fall.
"""

import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse)

import test_torch_train_parity as train_harness  # noqa: E402
from test_torch_train_parity import wgrad_calls  # noqa: E402,F401

VLM = "llava_next_mistral_7b"
LINEAR = ("1f1b", "zb-h1", "zb-h2")
CASES = [(n, p, None if n in LINEAR else 2 * p) for n in train_harness.SCHEDULES for p in (1, 2)]


@pytest.fixture
def vlm_arch(monkeypatch):
    monkeypatch.setattr(train_harness, "ARCH", VLM)


@pytest.mark.parametrize("name,p,n_layers", CASES,
                         ids=[f"{p}-{n}" + ("" if nl is None else f"-{nl}L")
                              for n, p, nl in CASES])
def test_vlm_pipelined_step_matches_jax(name, p, n_layers, vlm_arch):
    _, sg, _ = train_harness.check_pipelined_step(name, p, n_layers)
    assert float(sg["front_proj"].abs().sum()) > 0


def test_vlm_w_routes_products(vlm_arch, wgrad_calls):
    p, m = 2, 3
    _, cfg_t, _, spec_t, _, (st_t, sh_t, side_t) = train_harness._setup(p, m)
    sched = train_harness.zb_h1(p, m)
    program = train_harness.tlm.build_program(cfg_t, spec_t, sched.placement)
    train_harness.PipelineExecutor(program, train_harness.compile_plan(sched)).build_grad_fn()(
        st_t, sh_t, side_t)
    blocks = len(program.chunks[0].mods)
    n, width = cfg_t.extras_dict()["n_patches"], cfg_t.extras_dict()["frontend_dim"]
    front = ((spec_t.microbatch * n, width), (spec_t.microbatch * n, cfg_t.d_model))
    assert len(wgrad_calls) == 7 * blocks * p * m + m
    assert wgrad_calls.count(front) == m


def test_launcher_trains_the_vlm(capsys):
    from repro_torch.launch import train as launcher

    res = launcher.main(["--arch", VLM, "--reduced", "--device", "cpu", "--pipe-size", "2",
                         "--m", "4", "--seq-len", "16", "--steps", "3", "--schedule", "zb-v"])
    assert capsys.readouterr().out.splitlines()[-1].endswith("schedule=zb-v executor=eager")
    assert len(res.losses) == 3 and res.losses[-1] < res.losses[0]
    assert tuple(res.state["shared"]["front_proj"].shape) == (16, 48)
