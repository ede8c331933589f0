"""The port's memory layer (``repro_torch.core.memory``) against the JAX
package's, and its measured byte accounting against a live-byte tally.

* ``memory_timeline`` -- events, per-stage peaks and ``global_footprint`` --
  equals the JAX package's exactly for every schedule family (1F1B,
  interleaved 1F1B, ZB-H1, ZB-H2, ZB-1p, ZB-2p, ZB-V, V-Min, V-Half, and a
  ``v_flex`` search), on the simulator's clock under two time models and on
  the tick grid (host-only arithmetic on both sides).
* ``ActivationByteModel`` numbers equal the JAX package's at internlm2's full
  width (pure arithmetic: no model is built) and on the reduced model, over
  microbatch sizes, sequence lengths on both sides of the dense-attention
  threshold, chunk counts and both W-context cuts.
* ``zero1_state_bytes`` equals the JAX rule for every ``dp_size`` tried.
* Measured fidelity: the reduced model's executor is walked under each of the
  eight launcher schedules with a tally of the bytes its pools really keep
  alive (each storage once, parameters and side inputs left out; a
  residual's bytes read off its autograd graph, independently of the
  ``saved_tensors_hooks`` count behind ``slot_bytes``).  Per stage, the peak
  of ``measured_timeline`` is within 10% of the tallied peak.  The pool sizes
  of ``buffer_bytes`` (the JAX executor's allocation: each pool at its own
  peak) never fall below the tallied peak.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse)

import numpy as np  # noqa: E402

import repro.core.schedules as J  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import get_reduced as jax_get_reduced  # noqa: E402
from repro.core.memory import ActivationByteModel as JaxByteModel  # noqa: E402
from repro.core.memory import memory_timeline as jax_memory_timeline  # noqa: E402
from repro.core.simulator import TimeModel as JaxTimeModel  # noqa: E402
from repro.optim.sharding import zero1_state_bytes as jax_zero1_state_bytes  # noqa: E402

import repro_torch.core.schedules as T  # noqa: E402
from repro_torch.configs import get_config, get_reduced  # noqa: E402
from repro_torch.core.executor import PipelineExecutor  # noqa: E402
from repro_torch.core.memory import ActivationByteModel, measured_timeline  # noqa: E402
from repro_torch.core.memory import memory_timeline  # noqa: E402
from repro_torch.core.schedules import compile_plan  # noqa: E402
from repro_torch.core.simulator import TimeModel  # noqa: E402
from repro_torch.launch.train import make_schedule  # noqa: E402
from repro_torch.models.lm import RunSpec, build_program, init_params, side_inputs  # noqa: E402
from repro_torch.optim.sharding import zero1_state_bytes  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402
from test_torch_train_plan import _no_stored_plans  # noqa: E402,F401

ARCH = "internlm2_1_8b"
FAMILIES = {
    "1f1b": lambda mod, p, m: mod.one_f_one_b(p, m),
    "interleaved": lambda mod, p, m: mod.interleaved_1f1b(p, m),
    "zb-h1": lambda mod, p, m: mod.zb_h1(p, m),
    "zb-h2": lambda mod, p, m: mod.zb_h2(p, m),
    "zb-1p": lambda mod, p, m: mod.zb_1p(p, m),
    "zb-2p": lambda mod, p, m: mod.zb_2p(p, m),
    "zb-v": lambda mod, p, m: mod.zb_v(p, m),
    "v-min": lambda mod, p, m: mod.v_min(p, m),
    "v-half": lambda mod, p, m: mod.v_half(p, m),
    "v-flex": lambda mod, p, m: mod.v_flex(p, m, 2.0),
}
TIMES = {"unit": (1.0, 1.0, 1.0, 0.0), "skewed": (1.0, 1.3, 0.7, 0.15)}
TALLY_SCHEDULES = ("1f1b", "zb-h1", "zb-h2", "zb-1p", "zb-2p", "zb-v", "v-min", "v-half")
TALLY_RTOL = 0.10


def _same_timeline(a, b):
    assert (a.p, a.m_b, a.m_w) == (b.p, b.m_b, b.m_w)
    assert a.events == b.events
    for f in ("peak_act", "peak_wctx", "peak_total"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    times = sorted({ts for series in a.events for ts, _, _ in series})
    for t in times + [times[-1] / 2]:
        assert a.global_footprint(t) == b.global_footprint(t)


@pytest.mark.parametrize("p,m", [(4, 8), (3, 6)])
@pytest.mark.parametrize("name", list(FAMILIES))
def test_memory_timeline_matches_jax(name, p, m):
    mine, ref = FAMILIES[name](T, p, m), FAMILIES[name](J, p, m)
    for m_b, m_w in ((1.0, 0.5), (3.0, 2.0)):
        _same_timeline(memory_timeline(mine, tick_times=True, m_b=m_b, m_w=m_w),
                       jax_memory_timeline(ref, tick_times=True, m_b=m_b, m_w=m_w))
        for times in TIMES.values():
            for grouped in (False, True):
                _same_timeline(
                    memory_timeline(mine, TimeModel(*times, grouped_w=grouped), m_b, m_w),
                    jax_memory_timeline(ref, JaxTimeModel(*times, grouped_w=grouped), m_b, m_w))


BYTE_FIELDS = ("m_b_bytes", "m_w_bytes", "per_layer_act", "per_layer_wctx", "layers_per_stage",
               "tokens", "dtype_bytes")


@pytest.mark.parametrize("full", [True, False], ids=["full-width", "reduced"])
def test_byte_model_matches_jax(full):
    cfg = get_config(ARCH) if full else get_reduced(ARCH)
    cfg_j = jax_get_config(ARCH) if full else jax_get_reduced(ARCH)
    sched_t, sched_j = T.zb_h2(4, 8), J.zb_h2(4, 8)
    v_t, v_j = T.v_min(4, 8), J.v_min(4, 8)
    for b, s in ((1, 1024), (2, 32), (1, 2048), (1, 4096)):
        for p, C in ((4, 1), (4, 2), (3, 2)):
            for compact in (True, False):
                mine = ActivationByteModel.from_config(cfg, b, s, p, n_chunks=C, compact=compact)
                ref = JaxByteModel.from_config(cfg_j, b, s, p, n_chunks=C, compact=compact)
                assert {f: getattr(mine, f) for f in BYTE_FIELDS} == \
                    {f: getattr(ref, f) for f in BYTE_FIELDS}
                for (st, sj) in ((sched_t, sched_j), (v_t, v_j)):
                    for tick in (False, True):
                        assert mine.schedule_bytes(st, tick_times=tick) == \
                            ref.schedule_bytes(sj, tick_times=tick)


@pytest.mark.parametrize("dp", [1, 3, 8])
def test_zero1_state_bytes_matches_jax(dp):
    rng = np.random.default_rng(dp)
    shapes = [(), (7,), (3, 5), (2, 3, 4), (4097,)] + [tuple(rng.integers(1, 9, 3)) for _ in range(4)]
    tree_t = {f"l{i}": torch.empty(s) for i, s in enumerate(shapes)}
    tree_j = {f"l{i}": np.empty(s, np.float32) for i, s in enumerate(shapes)}
    for kw in ({}, {"n_moments": 1, "moment_dtype_bytes": 2}):
        assert zero1_state_bytes(tree_t, dp, **kw) == jax_zero1_state_bytes(tree_j, dp, **kw)


# --------------------------------------------------------------------- #
# measured fidelity against a live-byte tally of the executor's pools
# --------------------------------------------------------------------- #
def _graph_tensors(root: torch.Tensor):
    """Every tensor the autograd graph behind ``root`` keeps saved."""
    out, seen, stack = [], set(), [root.grad_fn]
    while stack:
        fn = stack.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        for name in dir(fn):
            if name.startswith("_saved_"):
                v = getattr(fn, name)
                out += [t for t in (v if isinstance(v, (tuple, list)) else (v,))
                        if isinstance(t, torch.Tensor)]
        if type(fn).__name__.endswith("Backward") and hasattr(fn, "saved_tensors"):
            out += list(fn.saved_tensors)  # a custom autograd.Function's ctx
        stack += [nxt for nxt, _ in fn.next_functions]
    return out


def _storages(tensors):
    return {t.untyped_storage().data_ptr(): t.untyped_storage().nbytes()
            for t in tensors if isinstance(t, torch.Tensor)}


class _Tally:
    """``on_tick`` hook: per stage, the bytes of the distinct storages its
    pools hold at the tick's start or at its end (a slot freed or filled in
    the tick was live during it), parameters and side inputs left out."""

    def __init__(self, p, skip):
        self.skip = skip
        self.peak = np.zeros(p)
        self.prev = [{} for _ in range(p)]
        self._res = {}  # id -> (residual, its storages): a graph's saves do not change

    def _of(self, kind, v):
        if kind not in ("res", "sink_res"):
            return _storages(tree_leaves(v))
        if id(v) not in self._res:
            if kind == "sink_res":
                (sr, lj), extra = v, [v[1]]
                blocks = [sr]
            else:
                blocks, extra = list(v), []
            ts = extra + [t for r in blocks for t in [r[0], r[1]] + _graph_tensors(r[1])]
            self._res[id(v)] = (v, _storages(ts))
        return self._res[id(v)][1]

    def __call__(self, t, pools):
        for s in range(len(self.prev)):
            now = {}
            for kind, per_stage in pools.items():
                for v in per_stage[s].values():
                    now.update(self._of(kind, v))
            both = {**self.prev[s], **now}
            self.prev[s] = now
            live = sum(n for k, n in both.items() if k not in self.skip)
            self.peak[s] = max(self.peak[s], live)


@pytest.mark.parametrize("name", TALLY_SCHEDULES)
def test_measured_timeline_matches_pool_tally(name):
    p, m = 4, 8
    sched = make_schedule(name, p, m)
    cfg = dataclasses.replace(get_reduced(ARCH), n_layers=2 * p)  # no padded groups
    spec = RunSpec(p=p, n_chunks=sched.n_chunks, microbatch=2, seq_len=32, m=m)
    prog = build_program(cfg, spec, sched.placement)
    stacked, shared = init_params(cfg, spec, sched.placement, seed=3, device="cpu")
    side = tree_map(torch.as_tensor, side_inputs(cfg, spec))
    exe = PipelineExecutor(prog, compile_plan(sched))
    stage0 = tuple(tree_map(lambda a: a[0], c) for c in stacked)

    mt = measured_timeline(exe, stage0, shared, side)
    bb = exe.buffer_bytes(stage0, shared, side)
    tally = _Tally(p, {t.untyped_storage().data_ptr() for t in tree_leaves((stacked, shared, side))})
    exe.build_grad_fn(on_tick=tally)(stacked, shared, side)

    np.testing.assert_allclose(mt.peak_total, tally.peak, rtol=TALLY_RTOL)
    assert bb["total"] >= tally.peak.max()
    # the pools are the plan's slot counts times the measured slot bytes
    assert bb["res"] == exe.plan.n_res_slots_joint * bb["res_slot_bytes"][0]
    assert bb["wctx"] == exe.plan.n_wctx_slots_joint * bb["wctx_slot_bytes"][0]
    assert bb["inbox"] == exe.plan.inbox_slot_total() * exe.channel_message_bytes()
    assert mt.alloc_total == bb["total"]
    assert mt.unit_bytes() == (sum(bb["res_slot_bytes"]), sum(bb["wctx_slot_bytes"]))
