"""One process a pipeline stage: the port's per-rank training step on the
CPU, ranks spawned with gloo between them (``launch/mesh.py::spawn_ranks``,
each with a join deadline, so a hang fails the test), reduced internlm2 in
float32.

(a) At p in {2, 4} under all eight launcher schedules (the V placement and
    ZB-1p/2p at ``n_layers = 2p``), the multi-process step equals the
    one-process port walk bit for bit: the step-0 loss and every gradient
    leaf (each rank's stage slice, the shared gradients on every rank), the
    losses, grad norms and ``amended`` of 2 AdamW + post-validation steps,
    and the parameters after them.
(b) At p=2 under zb-h1 and zb-v, from the JAX ``init_params`` weights
    (``interop.stage_share_from_numpy``), against the JAX launcher's
    multi-device step on 2 fake CPU devices in a process of its own
    (``tests/torch_jax_pipe_ref.py``, executor ``unroll``): losses and
    grad norms within 1e-5 relative (the trajectories' rule of
    ``tests/test_torch_train_parity.py``: the frameworks sum in other
    orders), ``amended`` equal, each rank's 2-step parameters within 1e-4
    relative L2 over the whole of them (the parity file's parameter
    tolerance) and each leaf within 1e-3: AdamW's first steps turn the
    rounding of a gradient near its eps into a visible step on a few
    elements and on the norm gains, which start at zero (``PARAM_RTOL``).
(c) A clip between stage 0's prefix norm and the full norm at p=2: the
    relay's partial decision on stage 0 steps, and is amended (rolled back
    and redone at the clip scale); the parameters equal the port's
    one-process ``sync`` mode to f32 rounding of the rollback (1e-6), and
    the one-process ``within_step`` mode bit for bit.
(d) Through that amended step the ranks' replicas of the shared parameters
    and their moments stay equal bit for bit.
(e) A plan with a missing sender fails fast, naming the tick, the rank and
    the channel: on every rank, at the check before any traffic; on one
    rank alone (the plans disagree), at the receiver's timeout.
"""

import os
import pathlib
import pickle
import re
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse)

import torch_dist_worker as W  # noqa: E402
from repro_torch.core.executor import PipelineExecutor  # noqa: E402
from repro_torch.launch.mesh import spawn_ranks  # noqa: E402
from repro_torch.launch.steps import TrainStepConfig, build_train_step  # noqa: E402
from repro_torch.launch.train import side_from_batch  # noqa: E402
from repro_torch.models.lm import RunSpec, build_program, init_params  # noqa: E402
from repro_torch.optim import adamw, postval  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
SCHEDULES = ("1f1b", "zb-h1", "zb-h2", "zb-v", "v-min", "v-half", "zb-1p", "zb-2p")
AT_2P = ("zb-v", "v-min", "v-half", "zb-1p", "zb-2p")  # n_layers = 2p, as the parity tests
STEPS, B, S = 2, 2, 16
JAX_RTOL = 1e-5
# the 2-step parameters against JAX: relative L2 over a rank's whole tree at
# the parameter tolerance of tests/test_torch_train_parity.py (GRAD_TOL, its
# clipped 2-step parameters), and a leaf's own at 1e-3.  AdamW's first steps
# turn the rounding of a gradient near its eps (1e-8) into a visible step: an
# element of zb-h1's wd whose step-0 gradient is -8.1e-9 moves 2.5e-4 apart
# (a 3e-3 step scaled by its g / (|g| + eps)), which alone takes the tree's
# gap to 1.04e-5, and the zero-initialised norm gains read up to 2e-4 of
# their small norms; a misplaced or stale leaf reads O(1)
PARAM_RTOL, LEAF_RTOL = 1e-4, 1e-3
SYNC_TOL = 1e-6
SPAWN_TIMEOUT_S = 300.0


def _case(name, p, **kw):
    return {"key": f"{name}-p{p}", "name": name, "p": p, "m": 2 * p, "b": B, "s": S,
            "steps": STEPS, "n_layers": 2 * p if name in AT_2P else None, **kw}


def _spawn(tmp, p, cases, timeout_s=60.0):
    job = tmp / "job.pkl"
    with open(job, "wb") as f:
        pickle.dump({"cases": cases, "timeout_s": timeout_s}, f)
    spawn_ranks(W.train_rank, p, (str(job), str(tmp)), timeout_s=SPAWN_TIMEOUT_S)
    return {c["key"]: [torch.load(tmp / f"{c['key']}.rank{r}.pt") for r in range(p)]
            for c in cases}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks' results of every schedule at p, one spawn a p."""
    got = {}

    def at(p):
        if p not in got:
            got[p] = _spawn(tmp_path_factory.mktemp(f"p{p}"), p, [_case(n, p) for n in SCHEDULES])
        return got[p]

    return at


def _one_process(case, clip=1.0, postval_mode="within_step", steps=STEPS):
    """The one-process port: the step-0 walk and ``steps`` training steps
    from the weights the ranks draw."""
    cfg = W.case_config(case)
    sched, plan = W.case_plan(case)
    spec = RunSpec(p=case["p"], n_chunks=sched.n_chunks, microbatch=B, seq_len=S, m=case["m"])
    stacked, shared = init_params(cfg, spec, sched.placement, seed=0, device="cpu")
    batches = W.case_batches(cfg, spec, max(1, steps))
    g, sg, loss = PipelineExecutor(build_program(cfg, spec, sched.placement), plan).build_grad_fn()(
        stacked, shared, side_from_batch(batches[0], spec, "cpu"))
    tcfg = TrainStepConfig(adamw=adamw.AdamWConfig(lr=3e-3, grad_clip=clip),
                           postval_mode=postval_mode)
    step, _ = build_train_step(cfg, spec, plan, sched.placement, tcfg)
    opt, sopt = adamw.init(stacked), adamw.init(shared)
    metrics = []
    for batch in batches[:steps]:
        stacked, shared, opt, sopt, met = step(stacked, shared, opt, sopt,
                                               side_from_batch(batch, spec, "cpu"))
        metrics.append((float(met["loss"]), float(met["grad_norm"]), bool(met["amended"])))
    return dict(grads=g, shared_grads=sg, loss=loss, metrics=metrics, params=stacked,
                shared=shared)


def _at(stacked, s):
    return tuple(tree_map(lambda a: a[s], chunk) for chunk in stacked)


def _assert_equal_trees(got, want, what):
    g, w = tree_leaves(got), tree_leaves(want)
    assert len(g) == len(w), what
    for i, (a, b) in enumerate(zip(g, w)):
        assert a.dtype == b.dtype and tuple(a.shape) == tuple(b.shape), f"{what} leaf {i}"
        assert torch.equal(a, b), f"{what} leaf {i} differs"


def _assert_ranks_equal_one_process(ranks, ref, steps=True):
    for r, got in enumerate(ranks):
        assert torch.equal(got["loss"], ref["loss"]), f"rank {r} step-0 loss"
        _assert_equal_trees(got["grads"], _at(ref["grads"], r), f"rank {r} gradients")
        _assert_equal_trees(got["shared_grads"], ref["shared_grads"], f"rank {r} shared gradients")
        if steps:
            assert got["metrics"] == ref["metrics"], f"rank {r} losses, grad norms, amended"
            _assert_equal_trees(got["params"], _at(ref["params"], r), f"rank {r} parameters")
            _assert_equal_trees(got["shared"], ref["shared"], f"rank {r} shared parameters")


# --------------------------------------------------------------------- #
# (a) every schedule at p in {2, 4}, bit for bit against one process
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("p", [2, 4])
@pytest.mark.parametrize("name", SCHEDULES)
def test_rank_step_equals_one_process_walk(name, p, runs):
    case = _case(name, p)
    ranks = runs(p)[case["key"]]
    _assert_ranks_equal_one_process(ranks, _one_process(case))
    # every rank sent and received messages, the shared replicas agree
    assert all(r["messages"] > 0 for r in ranks)
    for r in ranks[1:]:
        _assert_equal_trees(r["shared"], ranks[0]["shared"], "shared replica")


# --------------------------------------------------------------------- #
# (b) against the JAX launcher's multi-device step at p=2
# --------------------------------------------------------------------- #
JAX_P, JAX_M, JAX_LAYERS = 2, 2, 4
JAX_SCHEDULES = ("zb-h1", "zb-v")


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """The JAX launcher's step on 2 fake CPU devices, and the port's ranks
    from the same JAX weights."""
    tmp = tmp_path_factory.mktemp("jax")
    out = tmp / "jax.pkl"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, str(ROOT / "tests" / "torch_jax_pipe_ref.py"), "train", str(out),
         str(JAX_P), str(JAX_M), str(B), str(S), str(STEPS), str(JAX_LAYERS), *JAX_SCHEDULES],
        env=env, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with open(out, "rb") as f:
        ref = pickle.load(f)
    cases = [_case(n, JAX_P, key=f"jax-{n}", m=JAX_M, n_layers=JAX_LAYERS, jax_params=str(out))
             for n in JAX_SCHEDULES]
    return ref, _spawn(tmp, JAX_P, cases)


@pytest.mark.parametrize("name", JAX_SCHEDULES)
def test_rank_step_matches_jax_multi_device_step(name, jax_runs):
    ref, ranks = jax_runs[0][name], jax_runs[1][f"jax-{name}"]
    want = np.array([m[:2] for m in ref["metrics"]])
    for r, got in enumerate(ranks):
        np.testing.assert_allclose(np.array([m[:2] for m in got["metrics"]]), want,
                                   rtol=JAX_RTOL, atol=0)
        assert [m[2] for m in got["metrics"]] == [m[2] for m in ref["metrics"]]
        stacked_j, shared_j = ref["final"]
        want_leaves = (tree_leaves(tuple(tree_map(lambda a: np.asarray(a)[r], c)
                                         for c in stacked_j)) + tree_leaves(dict(shared_j)))
        got_leaves = tree_leaves(got["params"]) + tree_leaves(got["shared"])
        assert len(got_leaves) == len(want_leaves)
        diff = norm = 0.0
        for i, (a, b) in enumerate(zip(got_leaves, want_leaves)):
            a, b = a.double().numpy(), np.asarray(b, np.float64)
            assert a.shape == b.shape, f"rank {r} leaf {i}"
            d, n = np.linalg.norm(a - b), np.linalg.norm(b)
            assert d <= LEAF_RTOL * max(n, 1e-30), f"rank {r} leaf {i}: relative L2 gap {d / n}"
            diff, norm = diff + d * d, norm + n * n
        assert np.sqrt(diff / norm) <= PARAM_RTOL, (
            f"rank {r}: relative L2 gap {np.sqrt(diff / norm)}")


# --------------------------------------------------------------------- #
# (c), (d) a step whose relayed partial decision on stage 0 is amended
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def clipped(tmp_path_factory):
    case = _case("zb-h1", 2, key="clip", steps=1)
    ref = _one_process(case, steps=0)
    stage0 = postval.local_stats((_at(ref["grads"], 0), ref["shared_grads"])).sumsq
    full = postval.local_stats((ref["grads"], ref["shared_grads"])).sumsq
    assert stage0 < full
    clip = float((torch.sqrt(stage0) + torch.sqrt(full)) / 2)
    case.update(clip=clip, log_decisions=True)
    ranks = _spawn(tmp_path_factory.mktemp("clip"), 2, [case])["clip"]
    return case, clip, ranks


def test_clipped_step_amends_the_relayed_decision(clipped):
    case, clip, ranks = clipped
    # stage 0 stepped on its prefix (under the clip); stage 1's prefix is
    # the full norm, over it; both ranks' replicas followed stage 0's
    assert ranks[0]["decisions"] == [True]
    assert ranks[1]["decisions"] == [False, True]
    assert all(r["metrics"][0][2] for r in ranks)  # amended, on every rank
    assert ranks[0]["metrics"][0][1] > clip
    within = _one_process(case, clip=clip, steps=1)
    sync = _one_process(case, clip=clip, postval_mode="sync", steps=1)
    assert within["metrics"][0][2] and not sync["metrics"][0][2]
    _assert_ranks_equal_one_process(ranks, within)
    for r, got in enumerate(ranks):
        for a, b in zip(tree_leaves((got["params"], got["shared"])),
                        tree_leaves((_at(sync["params"], r), sync["shared"]))):
            torch.testing.assert_close(a, b, rtol=SYNC_TOL, atol=SYNC_TOL)


def test_shared_replicas_stay_equal_through_an_amended_step(clipped):
    _, _, ranks = clipped
    assert all(r["metrics"][0][2] for r in ranks)
    for r in ranks[1:]:
        _assert_equal_trees(r["shared"], ranks[0]["shared"], "shared replica")
        _assert_equal_trees(r["shared_opt"][1:], ranks[0]["shared_opt"][1:], "shared moments")
        assert torch.equal(r["shared_opt"][0], ranks[0]["shared_opt"][0])
        assert torch.equal(r["opt"][0], ranks[0]["opt"][0])  # one step count


# --------------------------------------------------------------------- #
# (e) a missing sender
# --------------------------------------------------------------------- #
def _first_forward_message(case):
    _, plan = W.case_plan(case)
    t = int(np.nonzero(plan.recv_valid[1].any(axis=-1))[0][0])
    assert plan.send_channel[0, t] == 0
    return t


@pytest.mark.parametrize("where", ["every rank", "rank 0 alone"])
def test_missing_sender_fails_fast_and_names_it(where, tmp_path):
    case = _case("1f1b", 2, key="missing", steps=0)
    t = _first_forward_message(case)
    case["drop_send"] = (0, t)
    if where == "rank 0 alone":
        case["drop_on"] = [0]  # rank 1 still expects the message: its wait times out
    t0 = time.monotonic()
    with pytest.raises(Exception) as info:
        _spawn(tmp_path, 2, [case], timeout_s=5.0)
    took = time.monotonic() - t0
    text = str(info.value)
    assert took < 60.0, f"took {took:.1f} s"
    if where == "every rank":
        assert f"tick {t}: rank 1 expects channel 0 from rank 0" in text, text[-2000:]
    else:
        assert re.search(r"tick \d+: rank [01], sending on channel\(s\) .*receiving on "
                         r"channel\(s\) \[\(\d, [01]\)\]", text), text[-2000:]
        assert "within 5 s" in text, text[-2000:]
