"""The planner's temp term in the port (``repro_torch``) on the CPU.

Reduced configs; parameters and gradients from numpy with a seed.

* (a) ``PipelineExecutor.accumulator_bytes`` equals the bytes of the
  storages one eager walk allocates for ``grads`` and ``shared_acc``, on
  one card and per device (a stage's slice plus the shared leaves), for
  reduced internlm2 and gpt3-1.5b at p in {1, 2, 4} on both placements.
* (b) ``optimizer_transient_bytes`` counts the leaves that ``adamw.step``
  really steps per stage (stage 0, with the shared leaves, the largest),
  and its one-card peak equals, within 256 bytes (a few 0-d tensors of the
  decisions), the live bytes the real ``_update`` allocates on the path it
  prices: one AdamW step a stage, optimistic (clip off) or scaled (clip on,
  norms over it), for fp32 and bf16 weights.  An amended step, which rolls
  back and steps again, holds more: documented as not priced.
* (c) With the same non-zero temp, ~30% of the cheapest total
  (``temp_bytes`` in the port, ``xla_temp_bytes`` in the JAX package), the
  two planners give the same candidates, choices, ``min_required_bytes``
  and binding terms over a budget sweep (``test_torch_planner.py``'s).
* (d) A calibration record written by ``launch/calibrate.py``'s writer from
  given peaks round-trips through a temporary table: read back by
  ``default_cuda_temp_bytes`` as a device's share (one card / p), its live
  part scaled by the M_B ratio down and up and its allocator part by the
  weights' ratio;
  the optimizer overhang read back too; other archs' and modes' records
  stay.
* (e) An arch with no record prices 0 remainder (the accumulators and the
  transient still priced), and the launcher says so.
* (f) ``launch.train.main --device cpu --memory-budget-mb`` prints temp
  with its three parts and the one-card total, and no ``not priced`` line;
  the eager and graph modes combine the transient as the planner says.
* (g) ``launch/calibrate.py`` raises without a card.
* The checked-in table holds both training configs under both modes, each
  naming its card.
* (h) ``launch/calibrate.py``'s cut (``--layers``, ``--p``,
  ``--schedules``, ``--experts``, ``--vocab``) reaches the record it
  writes (run on the CPU with the card's calls stubbed, reduced configs,
  seq 32), with the cut's weights and M_B as its scale references, and
  the default cell's checked-in records stay byte for byte; a record of
  the default cell has no ``cut``.  The checked-in qwen2-moe record
  (phase 21's cut: 4 layers, p=2, zb-h1 and zb-v, both modes) gives its
  planner a remainder and calibrated optimizer shares, and the launcher
  names the record instead of saying it is missing.
"""

import dataclasses
import json
import math

import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse)

import numpy as np  # noqa: E402
import test_torch_planner as planner_tests  # noqa: E402  (tests/ is on sys.path under pytest)

from repro.configs import get_reduced as jax_get_reduced  # noqa: E402
from repro.core.planner import HBMPlanner as JaxHBMPlanner  # noqa: E402

from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.core import memory as tmem  # noqa: E402
from repro_torch.core.executor import PipelineExecutor  # noqa: E402
from repro_torch.core.planner import HBMPlanner  # noqa: E402
from repro_torch.core.schedules import compile_plan  # noqa: E402
from repro_torch.launch import calibrate  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch import train as launcher  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

ARCHS = ("internlm2_1_8b", "gpt3_1_5b")
M, B, S = 4, 2, 8
# the real _update allocates a few 0-d tensors more than the priced path
# (the decisions' norms and scales): 4 bytes each
SCALAR_SLACK = 256


def _params(arch, p, name, dtype=None, seed=0):
    cfg = get_reduced(arch)
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    sched = launcher.make_schedule(name, p, M)
    spec = tlm.RunSpec(p=p, n_chunks=sched.n_chunks, microbatch=B, seq_len=S, m=M)
    stacked, shared = tlm.init_params(cfg, spec, sched.placement, seed=seed, device="cpu")
    return cfg, sched, spec, stacked, shared


def _storage_bytes(tensors):
    return sum({t.untyped_storage().data_ptr(): t.untyped_storage().nbytes()
                for t in tensors}.values())


# --------------------------------------------------------------------- (a)
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("p", [1, 2, 4])
@pytest.mark.parametrize("name", ["zb-h1", "zb-v"])
def test_accumulator_bytes_equal_the_walks(arch, p, name):
    cfg, sched, spec, stacked, shared = _params(arch, p, name)
    side = {k: torch.as_tensor(v, dtype=torch.long)
            for k, v in tlm.side_inputs(cfg, spec, seed=1).items()}
    exe = PipelineExecutor(tlm.build_program(cfg, spec, sched.placement), compile_plan(sched))
    grads, shared_acc, _ = exe.build_grad_fn()(stacked, shared, side)
    card, device = PipelineExecutor.accumulator_bytes(stacked, shared)
    assert card == _storage_bytes(tree_leaves((grads, shared_acc)))
    per_stage = sum(t[0].numel() * t.element_size() for t in tree_leaves(grads))
    assert device == per_stage + _storage_bytes(tree_leaves(shared_acc))
    assert all(t.dtype == torch.float32 for t in tree_leaves((grads, shared_acc)))


# --------------------------------------------------------------------- (b)
def _numpy_like(tree, rng, scale):
    return tree_map(lambda a: torch.as_tensor(
        (rng.standard_normal(a.shape) * scale).astype(np.float32)), tree)


def _run_update(stacked, shared, grads, shared_grads, acfg):
    """The real optimizer half of a step under the live-bytes count;
    returns (peak, elements per adamw.step call)."""
    state = launcher.init_state(stacked, shared)
    calls, real_step = [], adamw.step

    def counting_step(params, *a, **k):
        calls.append(sum(t.numel() for t in tree_leaves(params)))
        return real_step(params, *a, **k)

    adamw.step = counting_step
    try:
        with torch.no_grad(), steps._LiveBytes() as live:
            steps._update(stacked, shared, state["opt"], state["shared_opt"], grads, shared_grads,
                          torch.zeros(()), steps.TrainStepConfig(adamw=acfg))
    finally:
        adamw.step = real_step
    return live.peak, calls


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", [None, "bfloat16"])
@pytest.mark.parametrize("path", ["optimistic", "scaled"])
def test_optimizer_transient_is_what_update_allocates(arch, dtype, path):
    cfg, sched, spec, stacked, shared = _params(arch, 4, "zb-h1", dtype=dtype)
    rng = np.random.default_rng(7)
    # clip off: every stage steps optimistically and is kept; clip on with
    # every prefix norm over it: every stage skips and steps scaled once
    acfg = adamw.AdamWConfig(grad_clip=None if path == "optimistic" else 1.0)
    grads = _numpy_like(stacked, rng, 10.0)
    shared_grads = _numpy_like(shared, rng, 10.0)
    priced = steps.optimizer_transient_bytes(stacked, shared, acfg)
    peak, calls = _run_update(stacked, shared, grads, shared_grads, acfg)
    assert calls == list(priced.stage_elements)
    assert priced.stage_elements[0] == max(priced.stage_elements)
    assert priced.per_stage[0] == max(priced.per_stage)
    assert priced.one_card <= peak <= priced.one_card + SCALAR_SLACK
    # one stage alone, as one device of a pipeline steps it, holds less
    assert max(priced.per_stage) <= priced.one_card


def test_amended_step_holds_more_than_priced():
    """The documented exclusion: stage 0's partial norm under the clip and
    the full norm over it roll stage 0 back and step it again."""
    cfg, sched, spec, stacked, shared = _params("internlm2_1_8b", 4, "zb-h1")
    rng = np.random.default_rng(8)
    grads = _numpy_like(stacked, rng, 1.0)
    for g in tree_leaves(grads):
        g[0] *= 1e-6  # stage 0 tiny, later stages large
    shared_grads = _numpy_like(shared, rng, 1e-6)
    acfg = adamw.AdamWConfig()
    priced = steps.optimizer_transient_bytes(stacked, shared, acfg)
    peak, calls = _run_update(stacked, shared, grads, shared_grads, acfg)
    assert len(calls) == 5  # stage 0 twice (optimistic, then redone), stages 1-3 once
    assert peak > priced.one_card + SCALAR_SLACK


# --------------------------------------------------------------------- (c)
def test_budget_sweep_matches_jax_with_the_same_temp():
    ref = JaxHBMPlanner(jax_get_reduced(planner_tests.ARCH), p=planner_tests.P,
                        m=planner_tests.M, xla_temp_bytes=0.0, **planner_tests.RUN)
    cheapest = min(c.total_bytes for c in ref.candidates() if c.schedule is not None)
    temp = 0.3 / 0.7 * cheapest  # 30% of the cheapest total with it
    planner_tests.budget_sweep_matches_jax(temp)


# --------------------------------------------------------------------- (d)
def _runs(walk_reserved, walk_allocated, priced, rise):
    return {name: dict(reserved=w + d, allocated=a + d, walk_reserved=w, walk_allocated=a,
                       priced=pr, walk=pr / 4, transient=4e6)
            for name, w, a, pr, d in zip(("zb-h1", "zb-v", "1f1b"), walk_reserved,
                                         walk_allocated, priced, rise)}


def test_calibration_record_round_trips(tmp_path):
    path = tmp_path / "table.json"
    path.write_text(json.dumps({"other-arch": {"eager": {"cuda_temp_bytes": 5.0, "p": 1}}}))
    cfg = get_reduced("internlm2_1_8b")
    shape = dict(p=4, m=8, microbatch=2, seq_len=32, weights_bytes=5e6, card="a card, 700.00 W",
                 steps=2, seed=0)
    # the remainder's parts: the allocator's (walk_reserved - walk_allocated)
    # and the unpriced live bytes (walk_allocated - priced), each the largest
    eager = calibrate.calibration_record(
        cfg, "eager", _runs((10e6, 12e6, 9e6), (9.5e6, 10e6, 8.5e6), (9e6, 9e6, 9.5e6),
                            (1e6, 2e6, 0.0)), **shape)
    graph = calibrate.calibration_record(
        cfg, "graph", _runs((20e6, 18e6, 30e6), (16e6, 15e6, 29e6), (8e6, 8e6, 29e6),
                            (4e6, 4.4e6, 4.2e6)), **shape)
    parts = ("cuda_temp_bytes", "cuda_temp_fixed_bytes", "cuda_temp_scaled_bytes", "schedule")
    assert tuple(eager[k] for k in parts) == (3e6, 2e6, 1e6, "zb-v")
    assert tuple(graph[k] for k in parts) == (12e6, 4e6, 8e6, "zb-h1")
    assert eager["optimizer_overhang"] == 0.5
    assert graph["optimizer_overhang"] == pytest.approx(1.1, rel=1e-12)
    assert (eager["optimizer_reuse"], graph["optimizer_reuse"]) == (2e6 / 2.25e6, 0.0)
    for rec in (eager, graph):
        for key in ("arch_id", "m_b_bytes", "modeled_schedule_bytes", "p", "schedule", "shape",
                    "tokens", "tp", "executor_mode", "devices", "card"):
            assert key in rec, key
    calibrate.write_calibration_table([eager], path)
    calibrate.write_calibration_table([graph], path)
    table = json.loads(path.read_text())
    assert table["other-arch"] == {"eager": {"cuda_temp_bytes": 5.0, "p": 1}}
    assert set(table[cfg.name]) == {"eager", "graph"}
    m_b = eager["m_b_bytes"]
    assert m_b == tmem.ActivationByteModel.from_config(cfg, 2, 32, 4).m_b_bytes
    assert eager["weights_bytes"] == 5e6
    # overhang: the largest rise over the transient (4e6); reuse: the smallest
    # (transient - rise) over the walk (priced / 4), at least 0
    for mode, fixed, scaled, shares in (("eager", 2e6, 1e6, (0.5, 2e6 / 2.25e6)),
                                        ("graph", 4e6, 8e6, (1.1, 0.0))):
        # down, equal, up: the live part scales with M_B, the allocator's
        # with the weights
        for r_mb, r_w in ((0.25, 1.0), (1.0, 1.0), (3.0, 1.0), (1.0, 0.01), (2.0, 4.0)):
            got = tmem.default_cuda_temp_bytes(cfg.name, mode, m_b_bytes=r_mb * m_b,
                                               weights_bytes=r_w * 5e6, path=path)
            assert got == pytest.approx((fixed * r_w + scaled * r_mb) / 4, rel=1e-12)
        assert tmem.cuda_optimizer_shares(cfg.name, mode, path) == pytest.approx(shares,
                                                                                 rel=1e-12)
    # no record: the structural shares, all of the transient under graph, the
    # larger of walk and transient under eager
    assert tmem.cuda_optimizer_shares("other-arch", "graph", path) == (1.0, 0.0)
    assert tmem.cuda_optimizer_shares("other-arch", "eager", path) == (0.0, 1.0)


# --------------------------------------------------------------------- (e)
def test_uncalibrated_arch_prices_no_remainder(tmp_path, monkeypatch, capsys):
    assert tmem.default_cuda_temp_bytes("no-such-arch", "eager") == 0.0
    cfg = dataclasses.replace(get_reduced("internlm2_1_8b"), name="uncalibrated")
    for mode in ("eager", "graph"):
        bd = HBMPlanner(cfg, p=4, m=8, microbatch=2, seq_len=32,
                        executor_mode=mode).plan(math.inf).chosen.breakdown
        acc, optim, rest = bd.temp_parts
        assert rest == 0.0 and acc > 0 and bd.temp == acc + optim
    empty = tmp_path / "empty.json"
    empty.write_text("{}")
    monkeypatch.setattr(tmem, "CUDA_TEMP_TABLE", empty)
    launcher.main(planner_tests_launch() + ["--steps", "1", "--memory-budget-mb", "64"])
    out = capsys.readouterr().out
    assert "temp remainder 0: no calibration record for internlm2-1.8b under the eager " \
           "executor" in out


def planner_tests_launch():
    return ["--arch", "internlm2_1_8b", "--reduced", "--device", "cpu", "--pipe-size", "4",
            "--m", "8", "--microbatch", "2", "--seq-len", "32"]


# --------------------------------------------------------------------- (f)
def test_launcher_prints_temp_with_its_parts(capsys):
    res = launcher.main(planner_tests_launch() + ["--steps", "2", "--memory-budget-mb", "64"])
    out = capsys.readouterr().out
    assert "not priced" not in out
    assert "\n  temp " in out and "(temp = accumulators " in out
    assert " + optimizer " in out and " + remainder " in out
    assert "priced on one card holding all 4 stages: " in out and " of the walk; eager)" in out
    assert out.splitlines()[-1].endswith(f"schedule={res.schedule.name} executor=eager")


@pytest.mark.parametrize("mode", ["eager", "graph"])
def test_transient_combines_by_mode(mode):
    cfg = get_reduced("internlm2_1_8b")
    planner = HBMPlanner(cfg, p=4, m=8, microbatch=2, seq_len=32, executor_mode=mode)
    st = planner.state(1)
    for c in planner.plan(math.inf).plans:
        if c.schedule is None:
            continue
        bd = c.breakdown
        acc, optim, rest = bd.temp_parts
        sc = planner.state(c.schedule.n_chunks)
        assert acc == sc.acc
        f, g = tmem.cuda_optimizer_shares(cfg.name, mode)
        want = max(f * sc.transient, sc.transient - g * bd.schedule_bytes)
        assert optim == pytest.approx(want, rel=1e-12, abs=0.0)
        one = planner.one_card_bytes(c.schedule)
        assert one.transient == sc.transient_card and (one.overhang, one.reuse) == (f, g)
        charge = max(f * one.transient, one.transient - g * one.walk)
        assert one.total == pytest.approx(
            one.weights + one.accumulators + one.walk + one.remainder + charge, rel=1e-12)
        assert one.walk > 0 and one.remainder == 4 * planner.remainder() == 4 * rest
    # the budget-implied limit leaves out what no candidate escapes
    f, g = tmem.cuda_optimizer_shares(cfg.name, mode)
    floor = st.acc + planner.remainder() + (f if g else max(f, 1.0)) * st.transient
    assert planner._temp_floor(1) == pytest.approx(floor, rel=1e-12)


# --------------------------------------------------------------------- (g)
def test_calibrate_raises_without_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "t.json"
    with pytest.raises(RuntimeError, match="CUDA card"):
        calibrate.main(["--arch", "internlm2_1_8b", "--out", str(out)])
    assert not out.exists()


def test_checked_in_table_holds_both_training_configs():
    table = json.loads(tmem.CUDA_TEMP_TABLE.read_text())
    for name in ("internlm2-1.8b", "gpt3_1_5b"):
        assert set(table[name]) == {"eager", "graph"}, name
        for mode in table[name]:
            recs = tmem.cuda_temp_records(name, mode)
            # one record at the published depth, and internlm2's also at the
            # training phases' cut of chip_smoke.py, beside it
            assert sorted(map(tmem.record_key, recs), key=str) == (
                [(8, 4), None] if name == "internlm2-1.8b" else [None]), (name, mode)
            for rec in recs:
                assert rec["executor_mode"] == mode and rec["devices"] == 1 and rec["p"] == 4
                assert rec["tokens"] == 1024 and rec["cuda_temp_bytes"] >= 0
                assert "H100" in rec["card"] and rec["card"].rstrip().endswith("W")
                assert set(rec["runs"]) == set(launcher.SCHEDULES)


# --------------------------------------------------------------------- (h)
def _fake_card(monkeypatch, arch_reduced=True):
    """``launch/calibrate.py`` on the CPU: the card's calls stubbed, peaks
    from a counter, reduced configs for full ones."""
    peaks = iter(range(10**9, 10**12, 10**6))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for name in ("synchronize", "empty_cache", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_reserved", lambda *a: float(next(peaks)))
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: float(next(peaks)))
    monkeypatch.setattr(calibrate, "DEVICE", "cpu")
    monkeypatch.setattr(calibrate, "card_name", lambda: "a card, 700.00 W")
    monkeypatch.setattr(calibrate, "CELL", dict(calibrate.CELL, seq_len=32))
    if arch_reduced:
        monkeypatch.setattr(calibrate, "get_config", get_reduced)


@pytest.mark.parametrize("arch,argv,cut", [
    ("qwen2_moe_a2_7b", ["--layers", "4", "--p", "2", "--schedules", "zb-h1", "zb-v"],
     {"layers": 4, "p": 2, "schedules": ["zb-h1", "zb-v"]}),
    ("deepseek_v3_671b", ["--layers", "2", "--p", "2", "--schedules", "zb-h1", "zb-h2",
                          "--experts", "4", "--vocab", "128"],
     {"layers": 2, "p": 2, "schedules": ["zb-h1", "zb-h2"], "experts": 4, "vocab": 128}),
    ("llava_next_mistral_7b", ["--layers", "4", "--p", "2", "--schedules", "zb-h1", "zb-v"],
     {"layers": 4, "p": 2, "schedules": ["zb-h1", "zb-v"]}),
    ("whisper_tiny", ["--p", "2", "--schedules", "zb-h1", "zb-v", "--seq-len", "24"],
     {"layers": 2, "p": 2, "schedules": ["zb-h1", "zb-v"], "seq_len": 24}),
])
def test_calibrate_cut_reaches_the_record(arch, argv, cut, monkeypatch, tmp_path):
    _fake_card(monkeypatch)
    out = tmp_path / "t.json"
    out.write_text((tmem.CUDA_TEMP_TABLE).read_text())
    recs = calibrate.main(["--arch", arch, "--executor", "eager"] + argv + ["--out", str(out)])
    (rec,) = recs
    cfg = calibrate.cut_config(get_reduced(arch), cut["layers"], cut.get("experts"),
                               cut.get("vocab"))
    seq = cut.get("seq_len", 32)  # the faked cell's 32 unless the cut gives the tokens
    assert rec["cut"] == cut and rec["p"] == cut["p"] and rec["arch_id"] == cfg.name
    assert set(rec["runs"]) == set(cut["schedules"]) and rec["shape"] == f"p2_m8_b1_s{seq}"
    st = HBMPlanner(cfg, p=2, m=8, microbatch=1, seq_len=seq).state(1)
    assert rec["weights_bytes"] == st.params_card + st.optim_card
    assert rec["m_b_bytes"] == tmem.ActivationByteModel.from_config(cfg, 1, seq, 2).m_b_bytes
    assert tmem.cuda_temp_record(cfg.name, "eager", out, cut["layers"], cut["p"]) == rec
    table = json.loads(out.read_text())
    # the default cell's records stay byte for byte
    before = json.loads(tmem.CUDA_TEMP_TABLE.read_text())
    for name in ("internlm2-1.8b", "gpt3_1_5b"):
        assert json.dumps(table[name], sort_keys=True) == json.dumps(before[name],
                                                                     sort_keys=True)


def test_default_cell_record_has_the_checked_in_form():
    """No cut given, no ``cut`` key: a record of the default cell has the
    keys of the checked-in ones measured there; internlm2-1.8b's records at
    its training phases' cut in ``chip_smoke.py`` (8 layers, p=4, every
    schedule) have the same keys and the ``cut``."""
    table = json.loads(tmem.CUDA_TEMP_TABLE.read_text())
    cfg = get_reduced("internlm2_1_8b")
    rec = calibrate.calibration_record(
        cfg, "eager", _runs((10e6, 12e6, 9e6), (9.5e6, 10e6, 8.5e6), (9e6, 9e6, 9.5e6),
                            (1e6, 2e6, 0.0)), **calibrate.CELL, weights_bytes=5e6,
        card="a card, 700.00 W", steps=3, seed=0)
    for name in ("internlm2-1.8b", "gpt3_1_5b"):
        for mode in table[name]:
            for old in tmem.cuda_temp_records(name, mode, tmem.CUDA_TEMP_TABLE):  # read anew
                cut = old.pop("cut", None)
                assert cut in (None, {"layers": 8, "p": 4, "schedules": list(launcher.SCHEDULES)}
                               if name == "internlm2-1.8b" else None), (name, mode)
                assert set(old) == set(rec), (name, mode)
                assert old["shape"] == "p4_m8_b1_s1024"
    assert calibrate.cut_config(cfg) == cfg
    with pytest.raises(ValueError, match="no routed experts"):
        calibrate.cut_config(cfg, experts=4)
    with pytest.raises(SystemExit):
        calibrate.main(["--schedules", "no-such-schedule"])


MOE_CUT = dict(layers=4, p=2, schedules=["zb-h1", "zb-v"])


@pytest.mark.parametrize("mode", ["eager", "graph"])
def test_qwen2_moe_is_priced_with_a_remainder(mode):
    """The checked-in qwen2-moe record (measured on the card at phase 21's
    cut) gives its planner a remainder and calibrated optimizer shares,
    where without it the planner had only the structural shares."""
    from repro_torch.configs import get_config

    rec = tmem.cuda_temp_record("qwen2-moe-a2.7b", mode)
    assert rec is not None and rec["cut"] == MOE_CUT and rec["executor_mode"] == mode
    assert "H100" in rec["card"] and set(rec["runs"]) == set(MOE_CUT["schedules"])
    cfg = dataclasses.replace(get_config("qwen2_moe_a2_7b"), n_layers=4)
    planner = HBMPlanner(cfg, p=2, m=8, microbatch=1, seq_len=1024, executor_mode=mode)
    assert planner.remainder() > 0
    assert tmem.cuda_optimizer_shares(cfg.name, mode) == (rec["optimizer_overhang"],
                                                          rec["optimizer_reuse"])
    # at the cut the remainder is the record's own, a device's share
    assert planner.remainder() * 2 == pytest.approx(rec["cuda_temp_bytes"], rel=1e-9)


def test_launcher_names_the_record_that_prices_qwen2_moe(capsys):
    launcher.main(["--arch", "qwen2_moe_a2_7b", "--reduced", "--device", "cpu", "--pipe-size",
                   "2", "--m", "4", "--microbatch", "1", "--seq-len", "16", "--steps", "1",
                   "--memory-budget-mb", "64"])
    out = capsys.readouterr().out
    assert "no calibration record" not in out
    assert ("temp remainder from the calibration record of qwen2-moe-a2.7b under the eager "
            "executor, measured at 4 layers at p=2, zb-h1 zb-v") in out


FRONT_CUTS = {  # the checked-in records of the fronted families, at chip_smoke's cuts
    ("llava_next_mistral_7b", "llava-next-mistral-7b"): (
        dict(layers=8, p=2, schedules=["zb-h1", "zb-v"]), 1024),
    ("whisper_tiny", "whisper-tiny"): (
        dict(layers=4, p=2, schedules=["zb-h1", "zb-v"], seq_len=448), 448),
}


@pytest.mark.parametrize("mode", ["eager", "graph"])
@pytest.mark.parametrize("arch,name", sorted(FRONT_CUTS))
def test_front_models_are_priced_with_a_remainder(arch, name, mode):
    """The llava and whisper records (measured on the card at phase 25's
    and phase 24's cuts) price their runs: at the cut a device's share of
    the remainder is the record's own."""
    from repro_torch.configs import get_config

    cut, seq = FRONT_CUTS[(arch, name)]
    rec = tmem.cuda_temp_record(name, mode)
    assert rec is not None and rec["cut"] == cut and rec["executor_mode"] == mode
    assert "H100" in rec["card"] and rec["shape"] == f"p2_m8_b1_s{seq}"
    cfg = dataclasses.replace(get_config(arch), n_layers=cut["layers"])
    planner = HBMPlanner(cfg, p=2, m=8, microbatch=1, seq_len=seq, executor_mode=mode)
    assert planner.remainder() * 2 == pytest.approx(rec["cuda_temp_bytes"], rel=1e-9)
    assert rec["weights_bytes"] == planner.state(1).params_card + planner.state(1).optim_card


def test_records_of_two_depths_stay_side_by_side(tmp_path, capsys):
    """A record measured at another depth joins the arch's entry instead of
    replacing it; one at the same cut replaces its own; a run is priced by
    the record of its own depth, else by the full-depth one, and the
    launcher says when the record's depth is not the run's."""
    path = tmp_path / "t.json"
    full = {"arch_id": "a", "executor_mode": "eager", "p": 4, "cuda_temp_bytes": 1.0}
    cut8 = dict(full, cut={"layers": 8, "p": 4}, cuda_temp_bytes=2.0)
    cut8b = dict(cut8, cuda_temp_bytes=3.0)
    cut2 = dict(full, cut={"layers": 2, "p": 2}, cuda_temp_bytes=4.0)
    calibrate.write_calibration_table([full], path)
    assert json.loads(path.read_text())["a"]["eager"] == full
    calibrate.write_calibration_table([cut8, cut2], path)
    calibrate.write_calibration_table([cut8b], path)
    assert tmem.cuda_temp_records("a", "eager", path) == [full, cut2, cut8b]
    got = {(layers, p): tmem.cuda_temp_record("a", "eager", path, layers, p)["cuda_temp_bytes"]
           for layers, p in ((8, 4), (8, 2), (2, 2), (2, None), (24, 4), (None, None))}
    assert got == {(8, 4): 3.0, (8, 2): 1.0, (2, 2): 4.0, (2, None): 4.0, (24, 4): 1.0,
                   (None, None): 1.0}
    assert tmem.cuda_temp_record("b", "eager", path) is None
    # internlm2 at 8 layers on 4 stages is priced by its 8-layer record, the
    # reduced config (2 layers) by the full-depth one, and said so
    at8 = HBMPlanner(dataclasses.replace(get_reduced("internlm2_1_8b"), n_layers=8), p=4, m=8,
                     microbatch=2, seq_len=32, executor_mode="graph")
    rec8 = tmem.cuda_temp_record("internlm2-1.8b", "graph", layers=8, p=4)
    assert tmem.record_key(rec8) == (8, 4)
    assert at8.one_card_bytes(at8.plan(math.inf).chosen.schedule).overhang == \
        rec8["optimizer_overhang"]
    launcher.main(planner_tests_launch() + ["--steps", "1", "--memory-budget-mb", "64"])
    out = capsys.readouterr().out
    assert ("measured at the full depth at p=4, every schedule (NVIDIA H100 80GB HBM3, "
            "700.00 W), scaled to this run of 2 layers at p=4: no record was measured at that "
            "depth") in out
