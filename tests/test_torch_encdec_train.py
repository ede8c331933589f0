"""Reduced ``whisper_tiny`` (``encdec`` blocks behind the frame front)
trained by the port against the JAX package, in float32 on the CPU.

* One pipelined step at p in {1, 2} under all eight schedules of the
  launcher: loss within 1e-5 and every gradient leaf (the 18 products of
  each block, its norm gains and role scalars, ``front_proj`` and the
  embedding) within 1e-4, through ``test_torch_train_parity.py``'s
  harness with its arch set to whisper (random frames from
  ``side_inputs``).  1F1B, ZB-H1 and ZB-H2 at the reduced depth (2
  layers); the V schedules, ZB-1p and ZB-2p at ``n_layers = 2p``.
* W of one step: 18 ``wgrad_accum`` calls a block and one for
  ``front_proj`` a microbatch.
* A checkpoint that the JAX driver wrote for whisper (params and AdamW
  state after 3 steps, zero frames as both launchers feed) continues in
  the port: the next loss within 1e-5.
* The training launcher takes ``--arch whisper_tiny``: a reduced CPU run
  under zb-v, its losses fall.
"""

import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse)

import test_torch_driver as driver_harness  # noqa: E402
import test_torch_train_parity as train_harness  # noqa: E402
from test_torch_train_parity import wgrad_calls  # noqa: E402,F401

ENCDEC = "whisper_tiny"
LINEAR = ("1f1b", "zb-h1", "zb-h2")
CASES = [(n, p, None if n in LINEAR else 2 * p) for n in train_harness.SCHEDULES for p in (1, 2)]


@pytest.fixture
def encdec_arch(monkeypatch):
    monkeypatch.setattr(train_harness, "ARCH", ENCDEC)
    monkeypatch.setattr(driver_harness, "ARCH", ENCDEC)


@pytest.mark.parametrize("name,p,n_layers", CASES,
                         ids=[f"{p}-{n}" + ("" if nl is None else f"-{nl}L")
                              for n, p, nl in CASES])
def test_encdec_pipelined_step_matches_jax(name, p, n_layers, encdec_arch):
    g, sg, _ = train_harness.check_pipelined_step(name, p, n_layers)
    blk = g[0]["blocks"][0][0]
    assert all(float(blk[k].abs().sum()) > 0 for k in ("enc_on", "dec_on"))
    assert float(blk["xattn"]["wk"].abs().sum()) > 0 and float(sg["front_proj"].abs().sum()) > 0


def test_encdec_w_routes_products(encdec_arch, wgrad_calls):
    p, m = 2, 3
    _, cfg_t, _, spec_t, _, (st_t, sh_t, side_t) = train_harness._setup(p, m)
    sched = train_harness.zb_h1(p, m)
    program = train_harness.tlm.build_program(cfg_t, spec_t, sched.placement)
    train_harness.PipelineExecutor(program, train_harness.compile_plan(sched)).build_grad_fn()(
        st_t, sh_t, side_t)
    blocks = len(program.chunks[0].mods)
    assert len(wgrad_calls) == 18 * blocks * p * m + m


def test_jax_encdec_checkpoint_continues_in_the_port(tmp_path, encdec_arch):
    driver_harness.test_jax_checkpoint_continues_in_the_port(tmp_path)


def test_launcher_trains_the_encdec_model(capsys):
    from repro_torch.launch import train as launcher

    res = launcher.main(["--arch", ENCDEC, "--reduced", "--device", "cpu", "--pipe-size", "2",
                         "--m", "4", "--seq-len", "16", "--steps", "3", "--schedule", "zb-v"])
    assert capsys.readouterr().out.splitlines()[-1].endswith("schedule=zb-v executor=eager")
    assert len(res.losses) == 3 and res.losses[-1] < res.losses[0]
    blk = res.state["params"][0]["blocks"][0][0]
    assert blk["enc_on"].dim() == 1 and sorted(blk) == [
        "dec_attn", "dec_mlp", "dec_on", "enc_attn", "enc_mlp", "enc_on", "xattn"]
