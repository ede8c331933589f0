"""The port's in-place optimizer (``launch/steps.py::_update``) on the CPU.

``_update`` steps each stage's leaves slice by slice into the stored
parameters and moments (``adamw.step_`` / ``adamw.rollback_`` through
``postval``'s in-place variants).  Held here bit for bit (``torch.equal``
on every parameter, ``m`` and ``v``, the step count, ``amended`` and the
gradient norm) against the whole-stage functional path it replaced (each
stage's new tree from ``postval.optimistic_step`` / ``validate_and_fix`` /
``sync_step``, then copied back: ``chip_smoke.py::_whole_stage_update``),
over three steps, on reduced internlm2
(f32 and bf16), reduced qwen2-moe in bf16 (its routers fp32) and reduced
xlstm, at p=2 on both placements, on four paths:

* ``kept``: the clip off, every stage's optimistic step kept;
* ``skipped-then-scaled``: every prefix norm over the clip, so every stage
  skips and then steps at the true scale;
* ``amended``: stage 0's partial norm under the clip and the full norm over
  it, so stage 0 steps, rolls back and steps again at the true scale;
* ``sync``: the blocking baseline, one scaled step a stage.

``adamw.SLICE`` is set to 29 elements, so every leaf longer than that
spans several slices and ends in a ragged one (the reduced leaves longer
than 29 are 32 to 18,432 elements, none a multiple of 29); the 1- and
4-element leaves are one slice each.  Gradients come from numpy with a seed.  The parameters and
moments keep their addresses.
"""

import dataclasses
import importlib.util
import pathlib

import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse)

import numpy as np  # noqa: E402

from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch import train as launcher  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.tree import keyed_leaves, tree_leaves, tree_map  # noqa: E402

P, M, STEPS, SLICE = 2, 4, 3, 29
CASES = [("internlm2_1_8b", "float32"), ("internlm2_1_8b", "bfloat16"),
         ("qwen2_moe_a2_7b", "bfloat16"), ("xlstm_350m", "float32")]
PATHS = ("kept", "skipped-then-scaled", "amended", "sync")


def _chip_smoke():
    """``chip_smoke.py`` as a module: its ``_whole_stage_update`` is the
    optimizer half as it stood before it stepped in place (each stage's new
    state from the functional post-validation, then copied back), which the
    card's phase 34 holds ``_update`` to as well."""
    path = pathlib.Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _grads(stacked, shared, rng, path):
    """Accumulator-shaped fp32 gradients from numpy for ``path``."""
    scale = {"kept": 1.0, "skipped-then-scaled": 10.0, "amended": 1.0, "sync": 1.0}[path]

    def draw(tree):
        return tree_map(lambda a: torch.as_tensor(
            (rng.standard_normal(a.shape) * scale).astype(np.float32)), tree)

    grads, shared_grads = draw(stacked), draw(shared)
    if path == "amended":  # stage 0 (and the shared leaves) tiny, stage 1 large
        for g in tree_leaves(grads):
            g[0] *= 1e-6
        shared_grads = tree_map(lambda g: g * 1e-6, shared_grads)
    return grads, shared_grads


def _state(stacked, shared, rng):
    """The launcher's state, the moments made non-zero from numpy (the
    second ones positive), so the first step already reads them."""
    state = launcher.init_state(stacked, shared)
    for m, v in zip(tree_leaves((state["opt"].m, state["shared_opt"].m)),
                    tree_leaves((state["opt"].v, state["shared_opt"].v))):
        m.copy_(torch.as_tensor(rng.standard_normal(m.shape).astype(np.float32) * 1e-2))
        v.copy_(torch.as_tensor(np.abs(rng.standard_normal(v.shape)).astype(np.float32) * 1e-3))
    return state


def _clone(state):
    return tree_map(lambda a: a.clone(), state)


def _buffers(state):
    """Every parameter and moment of the launcher's state (not the counts)."""
    return tree_leaves((state["params"], state["shared"], state["opt"].m, state["opt"].v,
                        state["shared_opt"].m, state["shared_opt"].v))


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("arch,dtype", CASES)
@pytest.mark.parametrize("name", ["zb-h1", "zb-v"])
def test_in_place_update_is_the_whole_stage_update_bit_for_bit(arch, dtype, name, path,
                                                               monkeypatch):
    monkeypatch.setattr(adamw, "SLICE", SLICE)
    cs = _chip_smoke()
    cfg = dataclasses.replace(get_reduced(arch), dtype=dtype)
    sched = launcher.make_schedule(name, P, M)
    spec = tlm.RunSpec(p=P, n_chunks=sched.n_chunks, microbatch=1, seq_len=8, m=M)
    stacked, shared = tlm.init_params(cfg, spec, sched.placement, seed=4, device="cpu")
    rng = np.random.default_rng(11)
    got = _state(stacked, shared, rng)
    want = _clone(got)
    addresses = [t.data_ptr() for t in _buffers(got)]
    acfg = adamw.AdamWConfig(lr=1e-2, grad_clip=None if path == "kept" else 1.0)
    tcfg = steps.TrainStepConfig(adamw=acfg,
                                 postval_mode="sync" if path == "sync" else "within_step")
    sizes = [t.numel() for t in tree_leaves(got["params"][0])]
    assert all(n % SLICE for n in sizes if n > SLICE) and max(sizes) > 50 * SLICE
    for k in range(STEPS):
        grads, shared_grads = _grads(got["params"], got["shared"], rng, path)
        loss = torch.tensor(float(k))
        out_got = steps._update(got["params"], got["shared"], got["opt"], got["shared_opt"],
                                grads, shared_grads, loss, tcfg)
        t_want, amended, norm = cs._whole_stage_update(
            want["params"], want["shared"], want["opt"], want["shared_opt"], _clone(grads),
            _clone(shared_grads), tcfg)
        got = dict(params=out_got[0], shared=out_got[1], opt=out_got[2], shared_opt=out_got[3])
        want = dict(want, opt=want["opt"]._replace(t=t_want),
                    shared_opt=want["shared_opt"]._replace(t=t_want))
        mg = out_got[4]
        assert mg["amended"] == amended == (path in ("amended", "skipped-then-scaled")), k
        assert torch.equal(mg["grad_norm"], norm), k
        assert int(got["opt"].t) == int(want["opt"].t) == (k + 1), k
        for (key, a), (_, b) in zip(keyed_leaves(got), keyed_leaves(want)):
            assert a.dtype == b.dtype and torch.equal(a, b), (k, key)
    assert [t.data_ptr() for t in _buffers(got)] == addresses
    # the step moved every trainable leaf
    before = launcher.init_state(*tlm.init_params(cfg, spec, sched.placement, seed=4,
                                                  device="cpu"))
    moved = [not torch.equal(a, b) for a, b in zip(tree_leaves(got["params"]),
                                                    tree_leaves(before["params"]))]
    assert sum(moved) >= len(moved) - 2 * sched.n_chunks  # the frozen masks may stay


def test_in_place_step_and_rollback_are_the_functional_ones(monkeypatch):
    """``adamw.step_`` / ``rollback_`` on a tree of bf16, fp32 and 0-d leaves
    give the functional results' bits, write into their inputs and return
    them, and raise on a leaf that is not contiguous."""
    monkeypatch.setattr(adamw, "SLICE", 5)
    rng = np.random.default_rng(3)
    shapes = {"w": (6, 7), "b": (11,), "s": (), "h": (3, 4)}
    dt = {"w": torch.bfloat16, "b": torch.float32, "s": torch.float32, "h": torch.bfloat16}
    params = {k: torch.as_tensor(rng.standard_normal(v).astype(np.float32)).to(dt[k])
              for k, v in shapes.items()}
    grads = {k: torch.as_tensor(rng.standard_normal(v).astype(np.float32))
             for k, v in shapes.items()}
    st = adamw.AdamWState(torch.tensor(2, dtype=torch.int32),
                          {k: torch.as_tensor(rng.standard_normal(v).astype(np.float32) * 0.1)
                           for k, v in shapes.items()},
                          {k: torch.as_tensor(np.abs(rng.standard_normal(v)).astype(np.float32))
                           for k, v in shapes.items()})
    cfg = adamw.AdamWConfig(lr=3e-2)
    for scale in (1.0, torch.tensor(0.37)):
        want_p, want_s = adamw.step(params, st, grads, cfg, scale=scale)
        back_p, back_s = adamw.rollback(want_p, want_s, grads, cfg, scale=scale)
        p_, s_ = tree_map(lambda a: a.clone(), (params, st))
        got_p, got_s = adamw.step_(p_, s_, grads, cfg, scale=scale)
        assert got_p is p_ and got_s.m is s_.m and int(got_s.t) == int(want_s.t) == 3
        for a, b in zip(tree_leaves((got_p, got_s.m, got_s.v)),
                        tree_leaves((want_p, want_s.m, want_s.v))):
            assert a.dtype == b.dtype and torch.equal(a, b)
        got_p, got_s = adamw.rollback_(got_p, got_s, grads, cfg, scale=scale)
        assert int(got_s.t) == 2
        for a, b in zip(tree_leaves((got_p, got_s.m, got_s.v)),
                        tree_leaves((back_p, back_s.m, back_s.v))):
            assert torch.equal(a, b)
    bad = {"w": params["w"].t()}
    with pytest.raises(ValueError, match="contiguous"):
        adamw.step_(bad, adamw.AdamWState(st.t, {"w": st.m["w"]}, {"w": st.v["w"]}),
                    {"w": grads["w"]}, cfg)
