"""The port's executor modes (``TrainStepConfig.executor_mode``).

Counterpart of the JAX package's ``tests/test_specialized_executor.py``
contract and ``test_executor_mode_validation``.  ``"eager"`` is the host
walk (``PipelineExecutor.build_grad_fn``); ``"graph"`` records that walk
once into a CUDA graph and replays it (``GraphedGradFn``), so on the CPU
the tests hold what graph mode rests on:

  * an unknown mode raises; a graphed walk, and a graph-mode training step,
    raise on CPU tensors without running the walk;
  * the eager walk, which now adds into one stacked (p, ...) fp32
    accumulator per leaf and chunk and returns those tensors, still matches
    the JAX package under 1F1B, ZB-H1 and ZB-V (the harness of
    ``tests/test_torch_train_parity.py``, at its tolerances), and every
    wgrad accumulation lands in a returned gradient's storage;
  * two eager walks give the same results bit for bit and leave the
    parameters as they were (what the graph's warm-up walk relies on);
  * one eager walk issues no aten op that waits for the device or copies to
    the host (``_local_scalar_dense``, ``item``, ``nonzero``, ...): the CPU
    proxy for "capturable".  On the card ``chip_smoke.py`` captures it.

Reduced internlm2 in float32, p=2, m=4, s=16.  The test marked ``cuda``
replays a graph on the card against the eager walk and skips here.
"""

import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse)

import numpy as np  # noqa: E402
import test_torch_train_parity as parity  # noqa: E402  (tests/ is on sys.path under pytest)
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.core.executor import GraphedGradFn, PipelineExecutor  # noqa: E402
from repro_torch.core.schedules import compile_plan  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.launch.steps import TrainStepConfig, build_train_step  # noqa: E402
from repro_torch.launch.train import init_state, make_schedule  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

ARCH = "internlm2_1_8b"
P, M, B, S = 2, 4, 2, 16
# aten ops that read a device value on the host (a sync, which a CUDA graph
# capture refuses) or whose output shape depends on the data
HOST_READS = {"_local_scalar_dense", "item", "is_nonzero", "nonzero", "masked_select", "equal"}


def _setup(name):
    cfg = get_reduced(ARCH)
    sched = make_schedule(name, P, M)
    spec = tlm.RunSpec(p=P, n_chunks=sched.n_chunks, microbatch=B, seq_len=S, m=M)
    stacked, shared = tlm.init_params(cfg, spec, sched.placement, seed=0, device="cpu")
    side = {k: torch.as_tensor(v, dtype=torch.long)
            for k, v in tlm.side_inputs(cfg, spec, seed=1).items()}
    return cfg, spec, sched, stacked, shared, side


def _executor(name):
    cfg, spec, sched, stacked, shared, side = _setup(name)
    exe = PipelineExecutor(tlm.build_program(cfg, spec, sched.placement), compile_plan(sched))
    return exe, stacked, shared, side


def _train_step(name, mode):
    cfg, spec, sched, stacked, shared, side = _setup(name)
    step, _ = build_train_step(cfg, spec, compile_plan(sched), sched.placement,
                               TrainStepConfig(executor_mode=mode))
    return step, stacked, shared, side


def test_train_step_wraps_the_walk_in_graph_mode_only():
    assert TrainStepConfig().executor_mode == "eager"
    assert not isinstance(_train_step("zb-h1", "eager")[0].grad_fn, GraphedGradFn)
    assert isinstance(_train_step("zb-h1", "graph")[0].grad_fn, GraphedGradFn)


@pytest.mark.parametrize("mode", ["scan", "specialized", "unroll", ""])
def test_unknown_mode_raises(mode):
    with pytest.raises(ValueError, match="unknown executor_mode"):
        _train_step("zb-h1", mode)


@pytest.mark.parametrize("name", ["zb-h1", "zb-v"])
def test_graph_mode_refuses_cpu_tensors_without_walking(name):
    exe, stacked, shared, side = _executor(name)
    grad_fn = GraphedGradFn(exe.build_grad_fn())
    walks = []
    grad_fn.walk = lambda *a: walks.append(a)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        grad_fn(stacked, shared, side)
    assert walks == [] and grad_fn.captures == 0


def test_graph_mode_train_step_refuses_cpu_tensors():
    """No eager fallback: the graph-mode step raises on CPU tensors and
    leaves the parameters and moments as they were."""
    step, stacked, shared, side = _train_step("zb-h1", "graph")
    state = init_state(stacked, shared)
    before = [t.clone() for t in tree_leaves(state)]
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        step(state["params"], state["shared"], state["opt"], state["shared_opt"], side)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(state), before))


@pytest.mark.parametrize("name,n_layers", [("1f1b", None), ("zb-h1", None), ("zb-v", 2 * P)])
def test_eager_walk_with_stacked_accumulators_matches_jax(name, n_layers, monkeypatch):
    """The JAX parity of the eager walk, and every wgrad accumulation adds
    into the storage of a returned (stacked) gradient: no copy follows."""
    acc_storages = []
    real = tops.wgrad_accum

    def recording(a, g, acc):
        acc_storages.append(acc.untyped_storage().data_ptr())
        return real(a, g, acc)

    monkeypatch.setattr(tops, "wgrad_accum", recording)
    grads, _, _ = parity.check_pipelined_step(name, P, n_layers)
    assert acc_storages
    returned = {leaf.untyped_storage().data_ptr() for leaf in tree_leaves(grads)}
    assert set(acc_storages) <= returned
    for leaf in tree_leaves(grads):
        assert leaf.shape[0] == P and leaf.is_contiguous()


@pytest.mark.parametrize("name", ["zb-h2", "zb-v"])
def test_eager_walk_is_repeatable_and_leaves_the_parameters(name):
    exe, stacked, shared, side = _executor(name)
    before = [t.clone() for t in tree_leaves((stacked, shared, side))]
    grad_fn = exe.build_grad_fn()
    first = tree_leaves(grad_fn(stacked, shared, side))
    second = tree_leaves(grad_fn(stacked, shared, side))
    assert len(first) == len(second)
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves((stacked, shared, side)), before))


class _RecordOps(TorchDispatchMode):
    """Every aten op dispatched while active: (name, args, kwargs)."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        self.ops.append((func.overloadpacket.__name__, args, kwargs))
        return func(*args, **kwargs)


@pytest.mark.parametrize("name", ["1f1b", "zb-h1", "zb-v"])
def test_eager_walk_reads_nothing_back_to_the_host(name):
    exe, stacked, shared, side = _executor(name)
    grad_fn = exe.build_grad_fn()
    with _RecordOps() as rec:
        grads, shared_grads, loss = grad_fn(stacked, shared, side)
    names = {n for n, _, _ in rec.ops}
    assert {"mm", "index_add_"} <= names, sorted(names)  # it saw W and the embedding gradient
    assert not names & HOST_READS, sorted(names & HOST_READS)
    # no tensor made from host data (an upload from pageable memory), and no
    # copy that names another device
    assert not {"lift_fresh", "lift_fresh_copy"} & names
    for n, args, kwargs in rec.ops:
        if n == "_to_copy" and "device" in kwargs:
            assert kwargs["device"] == args[0].device, (n, kwargs)
    assert np.isfinite(float(loss))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["zb-h1", "zb-v"])
def test_graph_replays_the_eager_walk_on_the_card(name):
    """Reduced f32 on the card: the replay gives the eager walk's loss bit for
    bit and its gradients (the embedding's within 1e-6: index_add_ atomics);
    a second call replays without capturing; parameters at new addresses
    are captured again."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA card")
    exe, stacked, shared, side = _executor(name)
    to = lambda t: tree_map(lambda a: a.to("cuda"), t)  # noqa: E731
    stacked, shared, side = to(stacked), to(shared), to(side)
    g_e, sg_e, loss_e = exe.build_grad_fn()(stacked, shared, side)
    graphed = GraphedGradFn(exe.build_grad_fn())
    for _ in range(2):
        g_g, sg_g, loss_g = graphed(stacked, shared, side)
        torch.cuda.synchronize()
        assert graphed.captures == 1
        assert float(loss_g) == float(loss_e)
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(g_g), tree_leaves(g_e)))
        for key in sg_e:
            gap = float((sg_g[key] - sg_e[key]).norm() / sg_e[key].norm())
            assert gap <= (1e-6 if key == "embed" else 0.0), (key, gap)
    moved = tree_map(lambda a: a.clone(), stacked)
    _, _, loss_m = graphed(moved, shared, side)
    assert graphed.captures == 2 and float(loss_m) == float(loss_e)
