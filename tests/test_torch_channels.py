"""The pieces under the port's one-process-a-stage training step, on the CPU.

* The plan's channel helpers (``channel_live_ticks``, ``used_channels``,
  ``tick_column``, ``channel_liveness``, ``channel_edges``) against the JAX
  plan's, table for table, for the eight launcher schedules at p in {2, 3,
  4}; ``p2p.check_channels`` on a plan that lost a sender or a receiver.
* ``core/executor.py::microbatch_split`` against the JAX one on numpy
  batches.
* The post-validation relay (``postval.relay_prefix_stats``, ranks spawned
  with gloo) against the one-process ``pipe_prefix_stats`` bit for bit, and
  against the JAX ``pipe_prefix_stats`` (a log-depth scan: other order of
  the fp32 sums) on p fake devices in a process of its own, within 1e-6
  relative.
* ``p2p.sum_in_stage_order`` against the stage-order sum, bit for bit, with
  leaves written on no rank, one, two and all.
* The launcher: ``--procs`` must equal ``--pipe-size``; more ranks than
  cards needs ``--share-card``; ``--ckpt-dir`` with ``--procs`` and the
  ``nccl`` transport raise, naming the ROADMAP item; the reduced CPU run
  prints the transport first and the one-process launcher's losses.
"""

import os
import pathlib
import pickle
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse)

import torch_dist_worker as W  # noqa: E402
from repro.core.executor import microbatch_split as jax_microbatch_split  # noqa: E402
from repro.core.schedules import compile_plan as jax_compile_plan  # noqa: E402
from repro.launch.train import SCHEDULES as JAX_SCHEDULES  # noqa: E402

from repro_torch.core import p2p  # noqa: E402
from repro_torch.core.executor import microbatch_split  # noqa: E402
from repro_torch.core.schedules import compile_plan  # noqa: E402
from repro_torch.core.schedules.ir import N_CHANNELS  # noqa: E402
from repro_torch.launch import mesh  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.launch.train import SCHEDULES  # noqa: E402
from repro_torch.optim import postval  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
RELAY_JAX_RTOL = 1e-6
CASES = [(n, p) for p in (2, 3, 4) for n in sorted(SCHEDULES)]


# --------------------------------------------------------------------- #
# the channel helpers, table for table
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("name,p", CASES, ids=[f"{n}-p{p}" for n, p in CASES])
def test_channel_helpers_match_jax(name, p):
    plan = compile_plan(SCHEDULES[name](p, 2 * p))
    ref = jax_compile_plan(JAX_SCHEDULES[name](p, 2 * p))
    assert plan.n_ticks == ref.n_ticks
    np.testing.assert_array_equal(plan.channel_live_ticks(), ref.channel_live_ticks())
    assert plan.used_channels() == ref.used_channels()
    np.testing.assert_array_equal(plan.channel_liveness(), ref.channel_liveness())
    np.testing.assert_array_equal(plan.channel_liveness().sum(0), plan.channel_live_ticks())
    for t in range(plan.n_ticks):
        got, want = plan.tick_column(t), ref.tick_column(t)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{k} at tick {t}")
        for d in range(N_CHANNELS):
            assert plan.channel_edges(t, d) == ref.channel_edges(t, d)
    for s in range(p):
        p2p.check_channels(plan, s)  # every receive has a sender, every message a receiver


def test_check_channels_names_a_missing_sender_and_receiver():
    plan = compile_plan(SCHEDULES["1f1b"](2, 2))
    t = int(np.nonzero(plan.recv_valid[1].any(axis=-1))[0][0])
    lost = compile_plan(SCHEDULES["1f1b"](2, 2))
    lost.send_channel = lost.send_channel.copy()
    lost.send_channel[0, t] = -1
    p2p.check_channels(lost, 0)  # rank 0's row still holds together
    with pytest.raises(RuntimeError, match=f"tick {t}: rank 1 expects channel 0 from rank 0"):
        p2p.check_channels(lost, 1)
    unfiled = compile_plan(SCHEDULES["1f1b"](2, 2))
    unfiled.recv_valid = unfiled.recv_valid.copy()
    unfiled.recv_valid[1, t, 0] = False
    with pytest.raises(RuntimeError, match=f"tick {t}: rank 0 sends channel 0 to rank 1"):
        p2p.check_channels(unfiled, 1)


# --------------------------------------------------------------------- #
# microbatch_split
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("m", [1, 2, 4])
def test_microbatch_split_matches_jax(m):
    rng = np.random.default_rng(m)
    batch = {"tokens": rng.integers(0, 100, (8, 5)), "labels": rng.integers(0, 100, (8, 5)),
             "frames": rng.standard_normal((8, 3, 2)).astype(np.float32)}
    got, want = microbatch_split(batch, m), jax_microbatch_split(batch, m)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == (m, 8 // m) + batch[k].shape[1:]
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))
    t = microbatch_split({k: torch.from_numpy(v) for k, v in batch.items()}, m)
    for k in want:
        np.testing.assert_array_equal(t[k].numpy(), np.asarray(want[k]))


def test_microbatch_split_refuses_a_ragged_batch():
    with pytest.raises(ValueError, match="not divisible"):
        microbatch_split({"tokens": np.zeros((6, 2))}, 4)


# --------------------------------------------------------------------- #
# the relay, and the stage-order sum
# --------------------------------------------------------------------- #
def _stats(p, seed):
    """(p, 2) float32: each stage's sumsq (values whose fp32 sums depend on
    the order) and nonfinite flag (set on one stage past the first)."""
    rng = np.random.default_rng(seed)
    sq = (rng.random(p) * 10.0 ** rng.integers(-3, 4, p)).astype(np.float32)
    bad = np.zeros(p, np.float32)
    if p > 2:
        bad[p - 2] = 1.0
    return np.stack([sq, bad], axis=1)


def _relay(tmp, stats):
    path = tmp / "stats.npy"
    np.save(path, stats)
    p = stats.shape[0]
    mesh.spawn_ranks(W.relay_rank, p, (str(path), str(tmp)), timeout_s=120.0)
    return [torch.load(tmp / f"relay.rank{r}.pt") for r in range(p)]


@pytest.mark.parametrize("p", [2, 3, 4])
def test_relay_equals_one_process_prefix_sum(p, tmp_path):
    stats = _stats(p, p)
    got = _relay(tmp_path, stats)
    prefix, full = postval.pipe_prefix_stats(
        [postval.GradStats(torch.tensor(sq), torch.tensor(bool(bad))) for sq, bad in stats])
    for r in range(p):
        partial_r, full_r, first_r = got[r]
        assert torch.equal(partial_r[0], prefix[r].sumsq), f"rank {r} partial"
        assert bool(partial_r[1]) == bool(prefix[r].nonfinite)
        assert torch.equal(full_r[0], full.sumsq) and bool(full_r[1]) == bool(full.nonfinite)
        assert torch.equal(first_r[0], prefix[0].sumsq) and bool(first_r[1]) == bool(stats[0, 1])


@pytest.mark.parametrize("p", [2, 3, 4])
def test_relay_matches_jax_log_depth_scan(p, tmp_path):
    stats = _stats(p, 10 + p)
    got = _relay(tmp_path, stats)
    np.save(tmp_path / "jax_stats.npy", stats)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, str(ROOT / "tests" / "torch_jax_pipe_ref.py"), "relay",
                           str(tmp_path / "jax.npy"), str(tmp_path / "jax_stats.npy")],
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    ref = np.load(tmp_path / "jax.npy")  # (p, 4): partial sumsq, bad, full sumsq, bad
    for r in range(p):
        partial_r, full_r, _ = got[r]
        np.testing.assert_allclose(float(partial_r[0]), ref[r, 0], rtol=RELAY_JAX_RTOL)
        np.testing.assert_allclose(float(full_r[0]), ref[r, 2], rtol=RELAY_JAX_RTOL)
        assert float(partial_r[1]) == ref[r, 1] and float(full_r[1]) == ref[r, 3]


def test_sum_in_stage_order_adds_in_stage_order(tmp_path):
    p = 3
    rng = np.random.default_rng(7)
    written = {"none": (), "one": (1,), "two": (0, 2), "all": (0, 1, 2)}
    trees = [{k: (rng.standard_normal(13) * 10.0 ** rng.integers(-4, 5, 13)).astype(np.float32)
              if r in who else np.zeros(13, np.float32) for k, who in written.items()}
             for r in range(p)]
    with open(tmp_path / "trees.pkl", "wb") as f:
        pickle.dump(trees, f)
    mesh.spawn_ranks(W.sum_rank, p, (str(tmp_path / "trees.pkl"), str(tmp_path)), timeout_s=120.0)
    want = {}
    for k in written:
        run = torch.from_numpy(trees[0][k])
        for r in range(1, p):
            run = run + torch.from_numpy(trees[r][k])
        want[k] = run
    for r in range(p):
        got = torch.load(tmp_path / f"sum.rank{r}.pt")
        for k in written:
            assert torch.equal(got[k], want[k]), f"rank {r} leaf {k}"


# --------------------------------------------------------------------- #
# the launcher
# --------------------------------------------------------------------- #
BASE = ["--arch", "internlm2_1_8b", "--reduced", "--steps", "2", "--m", "2", "--seq-len", "8",
        "--microbatch", "1"]


def test_launcher_refuses_procs_other_than_pipe_size():
    with pytest.raises(ValueError, match="--procs 3 must equal --pipe-size 2"):
        train.main(BASE + ["--device", "cpu", "--procs", "3", "--pipe-size", "2"])


def test_launcher_needs_share_card_for_more_ranks_than_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="2 ranks, one a stage, need 2 CUDA cards and this "
                                           "machine has 1; pass --share-card"):
        train.main(BASE + ["--procs", "2", "--pipe-size", "2"])
    assert mesh.pipe_device("cuda", 1, 2, share_card=True) == torch.device("cuda", 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert mesh.pipe_device("cuda", 1, 2, share_card=False) == torch.device("cuda", 1)
    assert mesh.pipe_device("cpu", 1, 2, share_card=False) == torch.device("cpu")


def test_launcher_refuses_ckpt_dir_with_procs(tmp_path):
    with pytest.raises(NotImplementedError, match="per-rank checkpoints.*ROADMAP"):
        train.main(BASE + ["--device", "cpu", "--procs", "2", "--pipe-size", "2",
                           "--ckpt-dir", str(tmp_path)])


def test_nccl_transport_raises():
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1, item 1"):
        train.main(BASE + ["--device", "cpu", "--procs", "2", "--pipe-size", "2",
                           "--transport", "nccl"])
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1, item 1"):
        mesh.init_pipe_group(rank=0, world=2, init_method="file:///nonexistent", device="cpu",
                             transport="nccl")


def test_launcher_procs_prints_the_one_process_losses(capfd):
    args = ["--arch", "internlm2_1_8b", "--reduced", "--pipe-size", "2", "--device", "cpu",
            "--steps", "2", "--schedule", "zb-v"]
    res = train.main(args + ["--procs", "2"])
    out = capfd.readouterr().out
    lines = out.strip().splitlines()
    assert lines[0].startswith("pipe group: procs=2 transport=host"), lines[0]
    assert any(ln.startswith("rank 1: device cpu, stage 1's parameters") for ln in lines)
    multi = lines[-1]
    assert multi.endswith("schedule=zb-v executor=eager procs=2 transport=host"), multi
    one = train.main(args)
    single = capfd.readouterr().out.strip().splitlines()[-1]
    pick = lambda line: [w for w in line.split() if w.startswith("loss[")]  # noqa: E731
    assert pick(multi) == pick(single)
    assert len(res.losses) == 2
    np.testing.assert_allclose(res.losses, one.losses, rtol=1e-6, atol=0)


# --------------------------------------------------------------------- #
# one rank's share of the JAX package's state
# --------------------------------------------------------------------- #
def test_stage_share_from_numpy_takes_one_stage_of_the_jax_state():
    import jax

    from repro.configs import get_reduced as jax_get_reduced
    from repro.models import lm as jlm

    from repro_torch.interop import stage_share_from_numpy
    from repro_torch.tree import tree_leaves, tree_map

    p, stage = 2, 1
    sched = JAX_SCHEDULES["zb-v"](p, 4)
    spec = jlm.RunSpec(p=p, n_chunks=2, microbatch=1, seq_len=8, m=4)
    stacked, shared = jax.tree_util.tree_map(
        np.asarray, jlm.init_params(jax_get_reduced("internlm2_1_8b"), spec, sched.placement))
    rng = np.random.default_rng(0)
    like = lambda tree: tree_map(  # noqa: E731
        lambda a: rng.standard_normal(np.shape(a)).astype(np.float32), tree)
    opt, shared_opt = (np.int32(3), like(stacked), like(stacked)), (np.int32(3), like(shared),
                                                                     like(shared))
    params, sh, st, sst = stage_share_from_numpy(stacked, shared, stage, device="cpu", opt=opt,
                                                 shared_opt=shared_opt)
    at = lambda tree: tuple(tree_map(lambda a: a[stage], c) for c in tree)  # noqa: E731
    for got, want in ((params, at(stacked)), (sh, shared), (st.m, at(opt[1])), (st.v, at(opt[2])),
                      (sst.m, shared_opt[1]), (sst.v, shared_opt[2])):
        g, w = tree_leaves(got), tree_leaves(want)
        assert len(g) == len(w)
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b, a.numpy().dtype))
    assert int(st.t) == int(sst.t) == 3 and st.t.dtype == torch.int32
    assert all(a.dtype == torch.float32 for a in tree_leaves((st.m, st.v, sst.m, sst.v)))
