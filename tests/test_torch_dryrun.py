"""The port's dry run (``repro_torch.launch.dryrun``) on the CPU.

* (a) For every cell of ``cells_for`` on both production meshes, the port's
  p, tp, dp, m, microbatch, n_chunks, schedule, n_ticks and skip reason
  equal the JAX package's ``make_run_spec``, ``make_schedule`` and
  ``compile_plan`` / ``compile_infer_plan`` under the same binding with tp
  bound to no axis; the JAX side runs in a subprocess, since importing
  ``repro.launch.dryrun`` asks XLA for 512 devices.
* (b) ``modeled_schedule_bytes`` equal the JAX ``ActivationByteModel``'s
  exactly, at full width.
* (c) The dry run's slot bytes on fake tensors equal ``slot_bytes`` on real
  CPU tensors for a reduced config of each family whose CPU path saves
  what the card saves (dense, moe, mla, vlm, encdec, hybrid).  The ssm
  family's card path is the sLSTM kernel's ``SLSTMScan``, whose saved
  tensors the CPU's plain loop does not save, so its fake slots are held
  to a real CPU walk with the loop routed through ``SLSTMScan`` (its
  forward computed by the plain loop).
* (d) A train row's one-card total equals ``HBMPlanner.one_card_bytes``
  (measured fidelity on real CPU tensors) less its remainder.
* (e) Its step FLOPs equal ``FlopCounterMode`` over a real CPU step of the
  same run (every W product once, the remat's recompute included), and a
  closed-form count for reduced internlm2.
* (f) A serve row's cache bytes equal the real ``cache_init``'s.
* (g) At full width, three cells run in a subprocess each, exit 0 and
  stay under a resident-memory bound.
* (h) A bound tp axis raises; the mesh descriptions hold the JAX shapes.
* The fake branch of the kernels' entries launches nothing and moves no
  launch counter; real-tensor slot bytes are the same with storages keyed
  by identity as by address.
"""

import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse)

from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from repro_torch.configs import ARCH_IDS, get_reduced  # noqa: E402
from repro_torch.configs.shapes import SHAPES, cells_for  # noqa: E402
from repro_torch.core import executor  # noqa: E402
from repro_torch.core.executor import slot_bytes  # noqa: E402
from repro_torch.core.infer_executor import compile_infer_plan  # noqa: E402
from repro_torch.core.memory import ActivationByteModel  # noqa: E402
from repro_torch.core.planner import HBMPlanner, stage_program_factory  # noqa: E402
from repro_torch.core.schedules import compile_plan  # noqa: E402
from repro_torch.core.schedules.ir import Placement  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import rmsnorm as rms_kernel  # noqa: E402
from repro_torch.kernels import slstm_scan as slstm_kernel  # noqa: E402
from repro_torch.kernels import wgrad_accum as wgrad_kernel  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import AxisBinding, MeshSpec, make_production_mesh  # noqa: E402
from repro_torch.launch.steps import TrainStepConfig, build_train_step  # noqa: E402
from repro_torch.launch.train import init_state, make_schedule  # noqa: E402
from repro_torch.models.lm import RunSpec, front_len, init_params, side_inputs  # noqa: E402
from repro_torch.models.serve import build_serve_program  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.tree import tree_map  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
MESHES = (False, True)  # single pod, multi-pod

# the JAX side of (a) and (b): rows for every cell on both meshes, tp bound
# to no axis; meshes as descriptions (no devices are made)
JAX_GRID = r"""
import json, types, numpy as np
from repro.launch import dryrun as D
from repro.launch.mesh import AxisBinding
from repro.configs import ARCH_IDS, get_config
from repro.configs.shapes import SHAPES, cells_for
from repro.core.schedules import compile_plan
from repro.core.schedules.ir import Placement
from repro.core.infer_executor import compile_infer_plan
from repro.core.memory import ActivationByteModel

ticks, rows = {}, []
for multi in (False, True):
    shape, names = ((2, 16, 16), ("pod", "data", "model")) if multi else ((16, 16), ("data", "model"))
    mesh = types.SimpleNamespace(axis_names=names, devices=np.empty(shape))
    binding = AxisBinding(pipe="data", tp=None, dp="pod" if multi else None)
    p, tp, dp = binding.sizes(mesh)
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for sid, cell, skip in cells_for(arch):
            row = dict(multi=multi, arch=arch, shape=sid, skip=skip)
            if not skip:
                spec = D.make_run_spec(cfg, cell, mesh, binding, "zb-h2")
                v = D.make_run_spec(cfg, cell, mesh, binding, "zb-v")
                row.update(p=spec.p, tp=spec.tp_size, dp=dp, m=spec.m, microbatch=spec.microbatch,
                           n_chunks=spec.n_chunks, v_chunks=v.n_chunks, seq_len=spec.seq_len)
                if cell.kind == "train":
                    key = ("train", spec.p, spec.m)
                    if key not in ticks:
                        sched = D.make_schedule("zb-h2", spec.p, spec.m)
                        ticks[key] = (sched, compile_plan(sched).n_ticks)
                    sched, row["n_ticks"] = ticks[key]
                    row["schedule"] = "zb-h2"
                    row["modeled_schedule_bytes"] = ActivationByteModel.from_config(
                        cfg, spec.microbatch, spec.seq_len, spec.p, n_chunks=spec.n_chunks,
                        tp_size=spec.tp_size).schedule_bytes(sched)[2]
                else:
                    row["n_ticks"] = compile_infer_plan(
                        Placement.linear(spec.p, spec.n_chunks), spec.m).n_ticks
                    row["schedule"] = "fill-drain-" + cell.kind
            rows.append(row)
print(json.dumps(rows))
"""


def _env():
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")


@pytest.fixture(scope="module")
def jax_grid():
    out = subprocess.run([sys.executable, "-c", JAX_GRID], cwd=ROOT, env=_env(),
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


_TICKS = {}


def _port_row(multi, arch, sid, cell, skip):
    """The port's grid arithmetic for a cell: ``dryrun_cell``'s fields that
    need no fake walk."""
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    mesh = make_production_mesh(multi_pod=multi)
    binding = AxisBinding(pipe="data", tp=None, dp="pod" if multi else None)
    row = dict(multi=multi, arch=arch, shape=sid, skip=skip)
    if skip:
        return row
    spec = dryrun.make_run_spec(cfg, cell, mesh, binding, "zb-h2")
    v = dryrun.make_run_spec(cfg, cell, mesh, binding, "zb-v")
    row.update(p=spec.p, tp=spec.tp_size, dp=binding.sizes(mesh)[2], m=spec.m,
               microbatch=spec.microbatch, n_chunks=spec.n_chunks, v_chunks=v.n_chunks,
               seq_len=spec.seq_len)
    if cell.kind == "train":
        key = (spec.p, spec.m)
        if key not in _TICKS:
            sched = dryrun.make_schedule("zb-h2", spec.p, spec.m)
            _TICKS[key] = (sched, compile_plan(sched).n_ticks)
        sched, row["n_ticks"] = _TICKS[key]
        row["schedule"] = "zb-h2"
        row["modeled_schedule_bytes"] = ActivationByteModel.from_config(
            cfg, spec.microbatch, spec.seq_len, spec.p, n_chunks=spec.n_chunks,
            tp_size=spec.tp_size).schedule_bytes(sched)[2]
    else:
        row["n_ticks"] = compile_infer_plan(Placement.linear(spec.p, spec.n_chunks), spec.m).n_ticks
        row["schedule"] = "fill-drain-" + cell.kind
    return row


def test_grid_arithmetic_matches_jax(jax_grid):
    mine = [_port_row(multi, arch, sid, cell, skip) for multi in MESHES for arch in ARCH_IDS
            for sid, cell, skip in cells_for(arch)]
    assert len(mine) == len(jax_grid) == 2 * 4 * len(ARCH_IDS)
    for got, want in zip(mine, jax_grid):
        assert {k: v for k, v in got.items() if k != "modeled_schedule_bytes"} == \
            {k: v for k, v in want.items() if k != "modeled_schedule_bytes"}


def test_modeled_schedule_bytes_match_jax(jax_grid):
    trains = [r for r in jax_grid if r.get("schedule") == "zb-h2"]
    assert len(trains) == 2 * len(ARCH_IDS)
    for want in trains:
        got = _port_row(want["multi"], want["arch"], want["shape"], SHAPES[want["shape"]], None)
        assert got["modeled_schedule_bytes"] == want["modeled_schedule_bytes"], want["arch"]


@pytest.mark.parametrize("arch,sid", [("internlm2_1_8b", "train_4k"),
                                      ("xlstm_350m", "long_500k"),
                                      ("whisper_tiny", "prefill_32k")])
def test_dryrun_row_carries_the_grid_fields(arch, sid):
    """``dryrun_cell``'s own row (reduced width, the cell's grid shape)
    holds the fields the arithmetic above gives."""
    row = dryrun.dryrun_cell(arch, sid, reduced=True, verbose=False)
    cell = SHAPES[sid]
    want = _port_row(False, arch, sid, cell, None)
    cfg = get_reduced(arch)
    if cell.kind == "train":
        want["modeled_schedule_bytes"] = ActivationByteModel.from_config(
            cfg, want["microbatch"], want["seq_len"], want["p"], n_chunks=1
        ).schedule_bytes(_TICKS[(want["p"], want["m"])][0])[2]
    else:
        want["modeled_schedule_bytes"] = None
    for k in ("p", "tp", "dp", "m", "microbatch", "n_chunks", "seq_len", "n_ticks", "schedule",
              "modeled_schedule_bytes"):
        assert row[k] == want[k], k
    assert row["mesh"] == "16x16" and row["flops"] > 0 and row["total_bytes"] > 0


# --------------------------------------------------------------------- #
# (c)-(f): fake against real, reduced width
# --------------------------------------------------------------------- #
P, M, B, S = 2, 4, 2, 32
FAMILY_ARCHS = {"dense": "internlm2_1_8b", "moe": "qwen2_moe_a2_7b", "mla": "deepseek_v3_671b",
                "vlm": "llava_next_mistral_7b", "encdec": "whisper_tiny",
                "hybrid": "recurrentgemma_9b"}


def _fake_row(arch, schedule="zb-h1", **kw):
    over = dict(p=P, m=M, microbatch=B, seq_len=S)
    over.update(kw)
    return dryrun.dryrun_cell(arch, "train_4k", schedule=schedule, reduced=True, verbose=False,
                              **over)


def _real_slots(arch, n_chunks, seq=S):
    prog, stage, shared, side = stage_program_factory(get_reduced(arch), P, M, B, seq, "cpu")(
        n_chunks)
    return slot_bytes(prog, stage, shared, side)


def _listed(slots):
    return {k: (list(v) if isinstance(v, tuple) else v) for k, v in slots.items()}


@pytest.mark.parametrize("schedule", ["zb-h1", "zb-v"])
@pytest.mark.parametrize("family", sorted(FAMILY_ARCHS))
def test_fake_slots_equal_the_cpu_slots(family, schedule):
    arch = FAMILY_ARCHS[family]
    row = _fake_row(arch, schedule)
    assert row["device"] == "fake cpu"
    assert row["slots"] == _listed(_real_slots(arch, 2 if schedule == "zb-v" else 1))


def _card_route_slstm(monkeypatch):
    """Route the CPU's sLSTM loop through ``SLSTMScan``, as the card runs
    it, with its forward computed by the plain loop (every step's state
    kept, as the kernel writes it) and its backward by autograd through
    the plain loop: the saved tensors are the card's."""
    def forward(i_pre, f_pre, z):
        b, s, h = i_pre.shape
        c = torch.zeros((b, h))
        n, m = torch.zeros_like(c), torch.full_like(c, -1e30)
        out = []
        for t in range(s):
            out.append(ref.slstm_step(i_pre[:, t], f_pre[:, t], z[:, t], c, n, m))
            _, c, n, m = out[-1]
        return tuple(torch.stack([o[k] for o in out], dim=1) for k in range(4))

    def backward(i_pre, f_pre, z, c, n, m, dh):
        with torch.enable_grad():
            xs = [t.detach().requires_grad_(True) for t in (i_pre, f_pre, z)]
            hs, _ = ref.slstm_scan_ref(*xs)
            return torch.autograd.grad(hs, xs, dh)

    monkeypatch.setattr(slstm_kernel, "forward", forward)
    monkeypatch.setattr(slstm_kernel, "backward", backward)
    monkeypatch.setattr(ops, "slstm_scan", lambda i, f, z: (
        lambda hs, c, n, m: (hs, (c, n, m)))(*slstm_kernel.SLSTMScan.apply(i, f, z)))


@pytest.mark.parametrize("schedule", ["zb-h1", "zb-v"])
def test_ssm_fake_slots_are_what_slstm_scan_saves(schedule, monkeypatch):
    """xlstm: the fake walk's slots against a real CPU walk whose sLSTM loop
    saves what ``SLSTMScan`` saves on the card; the CPU's own plain loop
    saves more (a graph a step), so the two differ there."""
    arch, C = "xlstm_350m", 2 if schedule == "zb-v" else 1
    row = _fake_row(arch, schedule)
    plain = _listed(_real_slots(arch, C))
    _card_route_slstm(monkeypatch)
    card = _listed(_real_slots(arch, C))
    assert row["slots"] == card
    assert plain["res"] != card["res"]


@pytest.mark.parametrize("mode", ["eager", "graph"])
@pytest.mark.parametrize("schedule", ["zb-h1", "zb-v", "1f1b"])
def test_one_card_total_is_the_planners_less_its_remainder(schedule, mode):
    arch = "internlm2_1_8b"
    cfg = get_reduced(arch)
    row = _fake_row(arch, schedule, executor_mode=mode)
    planner = HBMPlanner(cfg, p=P, m=M, microbatch=B, seq_len=S, executor_mode=mode,
                         program_factory=stage_program_factory(cfg, P, M, B, S, "cpu"))
    one = planner.one_card_bytes(make_schedule(schedule, P, M))
    assert row["one_card"]["total"] == pytest.approx(one.total - one.remainder, rel=1e-12)
    assert row["one_card"]["walk"] == one.walk
    st = planner.state(2 if schedule == "zb-v" else 1)
    assert row["bytes"]["weights"] + row["bytes"]["moments"] == st.params + st.optim
    assert row["bytes"]["accumulators"] == st.acc


def _real_step_flops(arch, schedule, seq):
    cfg = get_reduced(arch)
    sched = make_schedule(schedule, P, M)
    spec = RunSpec(p=P, n_chunks=sched.n_chunks, microbatch=B, seq_len=seq, m=M)
    step, _ = build_train_step(cfg, spec, compile_plan(sched), sched.placement,
                               TrainStepConfig(adamw.AdamWConfig()))
    stacked, shared = init_params(cfg, spec, sched.placement, device="cpu")
    state = init_state(stacked, shared)
    side = tree_map(torch.as_tensor, side_inputs(cfg, spec))
    with FlopCounterMode(display=False) as fc:
        step(state["params"], state["shared"], state["opt"], state["shared_opt"], side)
    return int(fc.get_total_flops())


@pytest.mark.parametrize("arch,schedule,seq", [
    ("internlm2_1_8b", "zb-h1", S), ("internlm2_1_8b", "zb-v", S),
    ("internlm2_1_8b", "zb-h1", 2304),  # past 2 x 1024 queries: the remat's recompute in B
    ("qwen2_moe_a2_7b", "zb-h1", S), ("llava_next_mistral_7b", "zb-v", S),
    ("xlstm_350m", "zb-h1", S)])
def test_step_flops_equal_a_real_cpu_step(arch, schedule, seq):
    row = _fake_row(arch, schedule, seq_len=seq)
    assert row["step_flops"] == _real_step_flops(arch, schedule, seq)
    assert row["flops"] <= row["step_flops"]


def test_step_flops_match_the_closed_form():
    """Reduced internlm2 (dense GQA attention, gated MLP), p=2, m=4, 2 x 32
    tokens: F's products, B's two (its input gradients, and the
    attention's two more), W's one (each weight's gradient), per token and
    layer, plus the head's three and nothing for the embedding."""
    cfg = get_reduced("internlm2_1_8b")
    d, ff, V, L = cfg.d_model, cfg.d_ff, cfg.vocab, cfg.n_layers
    hd = cfg.head_dim or d // cfg.n_heads
    q, kv = cfg.n_heads * hd, cfg.n_kv_heads * hd
    proj = 2 * d * (q + 2 * kv) + 2 * q * d + 3 * 2 * d * ff  # wq wk wv, wo, wu wg wd
    attn = 2 * 2 * S * q  # scores and their product with v: each query against S keys
    per_token = L * (proj + attn + (proj + 2 * attn) + proj) + 3 * 2 * d * V
    row = _fake_row("internlm2_1_8b", "zb-h1")
    assert row["step_flops"] == M * B * S * per_token


@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k"])
@pytest.mark.parametrize("family", sorted(FAMILY_ARCHS) + ["ssm"])
def test_serve_cache_bytes_equal_cache_init(family, shape):
    arch = FAMILY_ARCHS.get(family, "xlstm_350m")
    cfg = get_reduced(arch)
    row = dryrun.dryrun_cell(arch, shape, reduced=True, p=P, m=M, microbatch=B, seq_len=S,
                             new_tokens=3, verbose=False)
    spec = RunSpec(p=P, n_chunks=1, microbatch=B, seq_len=S, m=M)
    _, cache_init = build_serve_program(cfg, spec, Placement.linear(P), "prefill")
    cache_len = row["cache_len"]
    assert cache_len == S + 3 + (front_len(cfg) if cfg.family == "vlm" else 0)
    real = cache_init(B, cache_len, device="cpu", lead=(M,))
    assert row["bytes"]["caches"] == dryrun._bytes(real)
    assert row["one_card"]["caches"] == P * dryrun._bytes(real)
    assert row["bytes"]["weights"] < row["one_card"]["weights"]


# --------------------------------------------------------------------- #
# (g) full width, each cell in a process of its own
# --------------------------------------------------------------------- #
RSS_BOUND_MB = 2048  # the three read ~300 MB here: fake tensors hold no data

RSS_WRAPPER = r"""
import resource, subprocess, sys
r = subprocess.run(sys.argv[1:], capture_output=True, text=True)
sys.stdout.write(r.stdout)
sys.stderr.write(r.stderr)
print("MAXRSS_MB", resource.getrusage(resource.RUSAGE_CHILDREN).ru_maxrss / 1024)
sys.exit(r.returncode)
"""


@pytest.mark.parametrize("arch,shape", [("internlm2_1_8b", "train_4k"),
                                        ("deepseek_v3_671b", "decode_32k"),
                                        ("xlstm_350m", "long_500k")])
def test_full_width_cells_run_in_bounded_memory(arch, shape):
    out = subprocess.run([sys.executable, "-c", RSS_WRAPPER, sys.executable, "-m",
                          "repro_torch.launch.dryrun", "--arch", arch, "--shape", shape],
                         cwd=ROOT, env=_env(), capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    assert lines[-2] == "1/1 cells OK"
    row = json.loads(lines[-4])
    assert (row["arch"], row["shape"], row["p"], row["tp"]) == (arch, shape, 16, 1)
    rss = float(lines[-1].split()[1])
    assert rss < RSS_BOUND_MB, f"{arch} {shape}: {rss:.0f} MB resident"


def test_skipped_cells_are_the_jax_ones(capsys):
    assert dryrun.main(["--arch", "whisper_tiny", "--shape", "long_500k"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[0]) == {"arch": "whisper_tiny", "shape": "long_500k",
                                    "skipped": dict((s, r) for s, _, r in
                                                    cells_for("whisper_tiny"))["long_500k"]}
    assert lines[-1] == "1/1 cells OK"


def test_an_erring_cell_fails_the_run(monkeypatch, capsys):
    def boom(*a, **k):
        raise RuntimeError("boom")

    monkeypatch.setattr(dryrun, "dryrun_cell", boom)
    assert dryrun.main(["--arch", "internlm2_1_8b", "--shape", "train_4k"]) == 1
    assert capsys.readouterr().out.strip().splitlines()[-1] == "0/1 cells OK"


# --------------------------------------------------------------------- #
# (h) the mesh descriptions
# --------------------------------------------------------------------- #
def test_bound_tp_axis_raises():
    with pytest.raises(NotImplementedError, match="tensor parallelism"):
        AxisBinding(pipe="data", tp="model")
    with pytest.raises(NotImplementedError, match="tensor parallelism"):
        AxisBinding(tp="model", dp="pod")


def test_production_meshes_have_the_jax_shapes():
    one, two = make_production_mesh(), make_production_mesh(multi_pod=True)
    assert (one.axis_names, one.shape, one.label) == (("data", "model"), (16, 16), "16x16")
    assert (two.axis_names, two.shape, two.label) == \
        (("pod", "data", "model"), (2, 16, 16), "2x16x16")
    assert AxisBinding(dp="pod").sizes(two) == (16, 1, 2)
    assert AxisBinding().sizes(one) == (16, 1, 1)
    with pytest.raises(ValueError):
        MeshSpec(("data",), (16, 16))


# --------------------------------------------------------------------- #
# the fake branch and the storage key
# --------------------------------------------------------------------- #
def _counts():
    return (rms_kernel.launches, dict(rms_kernel.launches_by_path), wgrad_kernel.launches,
            dict(wgrad_kernel.launches_by_path), slstm_kernel.launches,
            dict(slstm_kernel.launches_by_path))


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_fake_branch_launches_nothing(device, monkeypatch):
    """Fake tensors get the kernels' outputs (shape, dtype, device), the W
    op its accumulator back and its product counted, and no launch: the
    kernels are never even loaded.  (Fake cuda tensors run no autograd in
    a PyTorch built for the CPU, so the sLSTM Function runs on fake cpu.)"""
    from repro_torch.kernels import build

    monkeypatch.setattr(build, "load", lambda *a, **k: pytest.fail("a kernel was loaded"))
    before = _counts()
    with FakeTensorMode(), torch.no_grad():
        x = torch.empty((6, 64), dtype=torch.bfloat16, device=device)
        g = torch.empty((64,), dtype=torch.float32, device=device)
        y = ops.rmsnorm(x, g)
        assert (type(y).__name__, y.shape, y.dtype, y.device) == \
            ("FakeTensor", x.shape, x.dtype, x.device)
        a = torch.empty((16, 64), dtype=torch.bfloat16, device=device)
        gg = torch.empty((16, 8), dtype=torch.bfloat16, device=device)
        acc = torch.zeros((64, 8), dtype=torch.float32, device=device)
        with FlopCounterMode(display=False) as fc:
            assert ops.wgrad_accum(a, gg, acc) is acc
        assert fc.get_total_flops() == 2 * 16 * 64 * 8
        with pytest.raises(TypeError):
            ops.wgrad_accum(a, gg, acc.bfloat16())  # the kernel's checks still hold
    with FakeTensorMode():
        i = torch.empty((2, 5, 8), requires_grad=True)
        hs, (c, n, m) = ops.slstm_scan(i, torch.empty(2, 5, 8), torch.empty(2, 5, 8))
        assert (hs.shape, c.shape, type(hs.grad_fn).__name__) == \
            ((2, 5, 8), (2, 8), "SLSTMScanBackward")
        hs.sum().backward()
        assert i.grad.shape == i.shape
    assert _counts() == before


def test_real_tensors_never_take_the_fake_branch():
    x, g = torch.randn(3, 16), torch.randn(16)
    assert torch.equal(ops.rmsnorm(x, g), ref.rmsnorm_ref(x, g))
    hs, _ = ops.slstm_scan(*(torch.randn(1, 4, 8) for _ in range(3)))
    assert hs.grad_fn is None or "SLSTMScan" not in type(hs.grad_fn).__name__


@pytest.mark.parametrize("arch", ["internlm2_1_8b", "gpt3_1_5b", "qwen2_moe_a2_7b",
                                  "xlstm_350m", "whisper_tiny"])
@pytest.mark.parametrize("n_chunks", [1, 2])
def test_storage_identity_keys_give_the_address_keys_bytes(arch, n_chunks, monkeypatch):
    """Real tensors: ``slot_bytes`` keyed by storage identity is byte for
    byte what it was keyed by address."""
    cfg = dataclasses.replace(get_reduced(arch), n_layers=2 * P) if arch == "internlm2_1_8b" \
        else get_reduced(arch)
    prog, stage, shared, side = stage_program_factory(cfg, P, M, B, S, "cpu")(n_chunks)
    by_identity = slot_bytes(prog, stage, shared, side)
    monkeypatch.setattr(executor, "storage_key", lambda t: t.untyped_storage().data_ptr())
    assert slot_bytes(prog, stage, shared, side) == by_identity
