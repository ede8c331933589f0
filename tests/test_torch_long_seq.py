"""The port's long-sequence training path against the JAX package, in
float32 on the CPU: the chunked attention's remat and what a training step
keeps between F and B beyond 2 x 1024 queries.

1. ``attention`` past 2 x block (block 8, s = 40; the model's block of 1024
   at s = 2100) against the JAX ``attention``: the forward, and q, k and v's
   gradients against ``jax.vjp``, within 1e-5, causal, within a window,
   with a softcap, causal=False with sq != sk (the cross-attention) and dv
   != d (mla); with grad off the port's forward is the same bit for bit.
2. What the remat keeps: under a ``saved_tensors_hooks`` pack the chunked
   path saves no (block, sk) tensor, only q, k and v, so its bytes are
   exactly linear in s (64 against 128 at block 8).
3. The measured residual slot of reduced internlm2 (``slot_bytes``: one
   microbatch's F of a stage) per token at seq 3072 is below the one at
   seq 1024 (the dense path keeps the (s, s) scores there), as the JAX
   test asserts of its byte model (``tests/test_memory.py``); and 4. at
   4608 it is twice the one at 2304, within one block of q.
5. One pipelined step at seq 2304 (reduced internlm2, 2 layers, p in {1,
   2}, 1F1B, ZB-H1, ZB-H2, ZB-V; reduced gemma2's attn_local with window 8
   and reduced deepseek-v3's mla at p=1): loss within 1e-5 and every
   gradient leaf within 1e-4 of JAX's gradient of the groups in depth
   order (the chain rule over JAX's VJPs, ``tests/test_torch_recurrent_
   train.py::_by_stage_grads``), because of 6.: the JAX split of a
   chunked-attention block raises on jax 0.9 (a reference fault).
7. Calibration records of one arch, mode and depth at two sequence lengths
   stay side by side and each prices its own runs; every record of the
   checked-in table prices what it priced before the key had a sequence
   length.
"""

import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import test_torch_recurrent_train as chain  # noqa: E402
import test_torch_train_parity as harness  # noqa: E402
from repro.core.passes import auto_fbw  # noqa: E402
from repro.models import modules as jmod  # noqa: E402

from repro_torch.configs import all_configs, get_reduced  # noqa: E402
from repro_torch.core import memory as tmem  # noqa: E402
from repro_torch.core.executor import PipelineExecutor, slot_bytes  # noqa: E402
from repro_torch.core.planner import stage_program_factory  # noqa: E402
from repro_torch.core.schedules import compile_plan  # noqa: E402
from repro_torch.launch import calibrate  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models import modules as tmod  # noqa: E402

ATTN_TOL = 1e-5
LOSS_TOL, GRAD_TOL = 1e-5, 1e-4


# --------------------------------------------------------------------- 1.
# (b, sq, sk, hq, d, dv, block, causal, window, softcap)
ATTN_CASES = {
    "causal": (2, 40, 40, 3, 8, 8, 8, True, None, None),
    "window": (2, 40, 40, 3, 8, 8, 8, True, 11, None),
    "softcap": (2, 40, 40, 3, 8, 8, 8, True, None, 0.5),
    "cross": (2, 40, 24, 3, 8, 8, 8, False, None, None),
    "mla-dv": (1, 40, 40, 2, 12, 8, 8, True, None, None),
    "block-1024": (1, 2100, 2100, 2, 8, 8, 1024, True, None, None),
}


def _attn_inputs(b, sq, sk, hq, d, dv, seed=0):
    rng = np.random.default_rng(seed)
    q, k = (rng.standard_normal((b, n, hq, d)).astype(np.float32) for n in (sq, sk))
    v = rng.standard_normal((b, sk, hq, dv)).astype(np.float32)
    g = rng.standard_normal((b, sq, hq, dv)).astype(np.float32)
    return q, k, v, g


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_chunked_attention_and_its_gradients_match_jax(case):
    b, sq, sk, hq, d, dv, block, causal, window, softcap = ATTN_CASES[case]
    assert sq > 2 * block  # the chunked path in both packages
    q, k, v, g = _attn_inputs(b, sq, sk, hq, d, dv)
    kw = dict(causal=causal, window=window, softcap=softcap, block=block)
    y_j, vjp = jax.vjp(lambda a, b_, c: jmod.attention(a, b_, c, **kw),
                       *map(jnp.asarray, (q, k, v)))
    grads_j = vjp(jnp.asarray(g))
    ins = [torch.from_numpy(t).requires_grad_() for t in (q, k, v)]
    y_t = tmod.attention(*ins, **kw)
    y_t.backward(torch.from_numpy(g))
    np.testing.assert_allclose(y_t.detach().numpy(), np.asarray(y_j), rtol=ATTN_TOL, atol=ATTN_TOL)
    for name, t, gj in zip("qkv", ins, grads_j):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(gj), rtol=ATTN_TOL, atol=ATTN_TOL,
                                   err_msg=f"d{name}")
    with torch.no_grad():  # serving's path: the blocks as they are, the same numbers
        assert torch.equal(tmod.attention(*(t.detach() for t in ins), **kw), y_t.detach())


# --------------------------------------------------------------------- 2.
def _saved(s, block=8, b=2, hq=2, d=4):
    """(saved tensors, their bytes, each storage once) of the chunked path's
    F at s queries and keys."""
    q, k, v, _ = _attn_inputs(b, s, s, hq, d, d)
    ins = [torch.from_numpy(t).requires_grad_() for t in (q, k, v)]
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append(t) or t, lambda t: t):
        y = tmod.attention(*ins, block=block)
    stores = {t.untyped_storage().data_ptr(): t.untyped_storage().nbytes() for t in saved}
    del y
    return saved, sum(stores.values()), ins


def test_chunked_attention_keeps_no_scores():
    block = 8
    for s in (64, 128):
        saved, _, ins = _saved(s, block)
        assert saved
        assert not any(t.dim() >= 2 and tuple(t.shape[-2:]) == (block, s) for t in saved), \
            [tuple(t.shape) for t in saved]
        # the q blocks are views of q; k and v are saved as they came in
        kept = {t.untyped_storage().data_ptr() for t in saved}
        assert kept == {t.untyped_storage().data_ptr() for t in ins}
        assert _saved(s, block)[1] == sum(t.numel() * t.element_size() for t in ins)
    assert _saved(128, block)[1] == 2 * _saved(64, block)[1]


# --------------------------------------------------------------------- 3. 4.
_SLOTS = {}


def _res_slot(seq):
    """The residual slot of reduced internlm2 (d 48, 4 heads, 2 layers on
    one stage), measured by ``slot_bytes`` at ``seq`` tokens."""
    if seq not in _SLOTS:
        cfg = get_reduced("internlm2_1_8b")
        prog, stage, shared, side = stage_program_factory(cfg, 1, 1, 1, seq, "cpu")(1)
        _SLOTS[seq] = slot_bytes(prog, stage, shared, side)["res"][0]
    return _SLOTS[seq]


def test_residual_per_token_falls_past_2048():
    cfg = get_reduced("internlm2_1_8b")
    assert cfg.n_heads == 4 and cfg.d_model == 48
    assert _res_slot(3072) / 3072 < _res_slot(1024) / 1024


def test_residual_is_linear_past_2048():
    cfg = get_reduced("internlm2_1_8b")
    q_block = 1024 * cfg.d_model * 4  # one block of q, fp32: what padding it could hold
    assert abs(_res_slot(4608) - 2 * _res_slot(2304)) <= q_block


# --------------------------------------------------------------------- 5.
LONG_SEQ, LONG_M = 2304, 2
STEP_CASES = ([("internlm2_1_8b", n, p) for n in ("1f1b", "zb-h1", "zb-h2", "zb-v")
               for p in (1, 2)]
              + [("gemma2_2b", "zb-h1", 1), ("deepseek_v3_671b", "zb-h1", 1)])
_REF = {}


def _reference(arch, cfg, spec, placement, stacked, shared, side):
    """JAX's loss and gradients of the groups in depth order, by the chain
    rule over its VJPs; the helper's own cache (keyed without the sequence
    length) is left as it was."""
    key = (arch, spec.p, spec.m, spec.seq_len, placement.stage_seq)
    if key not in _REF:
        _REF[key] = chain._by_stage_grads(cfg, spec, placement, stacked, shared, side)
        chain._BY_STAGE_CACHE.pop((cfg, spec.p, spec.m, placement.stage_seq), None)
    return _REF[key]


@pytest.mark.parametrize("arch,name,p", STEP_CASES, ids=[f"{a}-{p}-{n}" for a, n, p in STEP_CASES])
def test_long_pipelined_step_matches_jax(arch, name, p, monkeypatch):
    monkeypatch.setattr(harness, "ARCH", arch)
    port_sched, jax_sched = (f(p, LONG_M) for f in harness.SCHEDULES[name])
    cfg_j, cfg_t, spec_j, spec_t, (st_j, sh_j, side_j), (st_t, sh_t, side_t) = harness._setup(
        p, LONG_M, b=1, s=LONG_SEQ, placement=jax_sched.placement)
    if arch == "gemma2_2b":
        assert 0 < cfg_t.extras_dict()["window"] < LONG_SEQ
    g_j, sg_j, loss_j = _reference(arch, cfg_j, spec_j, jax_sched.placement, st_j, sh_j, side_j)
    program = tlm.build_program(cfg_t, spec_t, port_sched.placement)
    g_t, sg_t, loss_t = PipelineExecutor(program, compile_plan(port_sched)).build_grad_fn()(
        st_t, sh_t, side_t)
    harness._close(loss_t, loss_j, LOSS_TOL)
    harness._close_trees(g_t, g_j, GRAD_TOL)
    harness._close_trees(sg_t, sg_j, GRAD_TOL)


# --------------------------------------------------------------------- 6.
def test_jax_split_of_a_chunked_attention_block_fails():
    """Reference fault: on jax 0.9 ``auto_fbw``'s B of a block whose
    attention takes the chunked path (a scan of checkpointed blocks) fails
    while it inlines the wrappers, as it does for the recurrent kinds' scan
    bodies (ROADMAP Queue 3); the port is held to ``jax.vjp`` instead."""
    cfg = get_reduced("internlm2_1_8b")
    lcfg = tlm.layer_cfg(cfg)
    ctx = jmod.ShardCtx()
    params = jmod.init_layer("attn", jax.random.PRNGKey(0), lcfg, ctx, jnp.float32)
    s, block = 40, 8
    x = jnp.asarray(np.random.default_rng(1).standard_normal((1, s, cfg.d_model)), jnp.float32)

    def block_fn(p, xx, side):
        q = (xx @ p["wq"]).reshape(1, s, cfg.n_heads, -1)
        return xx + jmod.attention(q, q, q, block=block).reshape(xx.shape)

    mod = auto_fbw(block_fn)
    y, res = mod.fwd(params, x, {})
    with pytest.raises(AssertionError):
        mod.bwd_x(params, res, jnp.ones_like(y), {})


# --------------------------------------------------------------------- 7.
def _rec(p, seq=None, layers=None, value=1.0, mode="graph"):
    cut = None if layers is None else dict(layers=layers, p=p, schedules=["zb-h1"],
                                           **({} if seq is None else {"seq_len": seq}))
    return {"arch_id": "internlm2-1.8b", "executor_mode": mode, "p": p, "card": "a card",
            "cuda_temp_bytes": value, "cuda_temp_fixed_bytes": value,
            "cuda_temp_scaled_bytes": 0.0, "optimizer_overhang": 1.0, "optimizer_reuse": 0.0,
            **({} if cut is None else {"cut": cut})}


def test_records_of_two_sequence_lengths_each_price_their_own(tmp_path):
    path = tmp_path / "t.json"
    full = _rec(4, value=1.0)  # the full depth (24 layers) at the cell's 1024
    long = _rec(4, 4096, 24, value=2.0)
    cut8 = _rec(4, None, 8, value=3.0)
    calibrate.write_calibration_table([full, cut8], path)
    calibrate.write_calibration_table([long], path)
    assert tmem.cuda_temp_records("internlm2-1.8b", "graph", path) == [full, cut8, long]
    assert [tmem.record_key(r) for r in (full, long, cut8)] == [
        (None, 4, 1024), (24, 4, 4096), (8, 4, 1024)]
    got = {run: tmem.cuda_temp_record("internlm2-1.8b", "graph", path, *run)["cuda_temp_bytes"]
           for run in ((24, 4, 1024), (24, 4, 4096), (24, 4, 512), (24, 4, 2048), (24, 4, 3072),
                       (24, 4, None), (8, 4, 4096), (8, 4, 512), (24, 2, 4096), (2, 4, 4096),
                       (None, None, None))}
    assert got == {(24, 4, 1024): 1.0, (24, 4, 4096): 2.0, (24, 4, 512): 1.0,
                   (24, 4, 2048): 1.0, (24, 4, 3072): 1.0, (24, 4, None): 1.0,
                   (8, 4, 4096): 3.0, (8, 4, 512): 3.0, (24, 2, 4096): 1.0, (2, 4, 4096): 1.0,
                   (None, None, None): 1.0}
    # a record of the same key replaces its own
    calibrate.write_calibration_table([dict(long, cuda_temp_bytes=5.0)], path)
    assert tmem.cuda_temp_record("internlm2-1.8b", "graph", path, 24, 4, 4096)[
        "cuda_temp_bytes"] == 5.0


def _old_record(recs, layers, p):
    """The rule before the key had a sequence length: the record measured
    at the run's (layers, p), else the full-depth one, else the first."""
    def rank(rec):
        cut = rec.get("cut")
        if cut is None:
            return 1
        return 0 if layers == cut["layers"] and p in (None, cut["p"]) else 2

    return min(recs, key=rank, default=None)


LONG_RECORDS = {(24, 4, 4096): {"1f1b", "zb-h1", "zb-v"}}
# the records that joined the table with the seq key: internlm2's at seq 4096
# and gpt3's at the depth cut of chip_smoke.py phase 18
NEW_RECORDS = {("internlm2-1.8b", "graph"): set(LONG_RECORDS),
               ("gpt3_1_5b", "graph"): {(8, 4, 1024)}}


def test_checked_in_records_price_what_they_priced():
    """Every run that a checked-in record priced before the records of
    ``NEW_RECORDS`` joined the table (at each record's depth and p, the
    full depth, reduced depths, every seq a phase or test runs, and none)
    is priced by the same record now; each new record prices the runs of
    its own depth, p and seq (and of its depth and p at any seq when it
    was measured at the cell's, or when the run names none: no record of
    that depth priced them before, but the full depth's extrapolation)."""
    table = tmem._cuda_temp_table()
    full = {c.name: c.n_layers for c in all_configs().values()}
    for name, modes in table.items():
        for mode in modes:
            recs = tmem.cuda_temp_records(name, mode)
            added = NEW_RECORDS.get((name, mode), set())
            assert added <= {tmem.record_key(r) for r in recs}, (name, mode)
            before = [r for r in recs if tmem.record_key(r) not in added]
            runs = {(tmem.record_key(r)[0] or full[name], tmem.record_key(r)[1]) for r in recs}
            for layers, p in runs | {(full[name], 4), (full[name], 2), (2, 4), (4, 2)}:
                for seq in (32, 64, 448, 512, 1024, 2048, 3072, 4096, None):
                    got = tmem.cuda_temp_record(name, mode, layers=layers, p=p, seq_len=seq)
                    key = tmem.record_key(got)
                    if key in added:  # a new record: its own depth and p
                        assert key[:2] == (layers, p) and (seq in (None, key[2]) or key[2] == 1024)
                    else:
                        assert got is _old_record(before, layers, p), (name, mode, layers, p, seq)
    for key, names in LONG_RECORDS.items():
        got = tmem.cuda_temp_record("internlm2-1.8b", "graph", None, *key)
        assert tmem.record_key(got) == key and "H100" in got["card"], key
        assert got["runs"].keys() == names and got["shape"] == "p4_m8_b1_s4096"


def test_launcher_names_the_record_of_its_sequence(monkeypatch, capsys, tmp_path):
    """The training launcher prices a run by the record of its own depth and
    seq, else by its depth's at the cell's seq, and says so."""
    from repro_torch.launch import train as launcher

    path = tmp_path / "t.json"
    calibrate.write_calibration_table([_rec(4, mode="eager"), _rec(4, None, 2, 2e6, "eager"),
                                       _rec(4, 64, 2, 3e6, "eager")], path)
    monkeypatch.setattr(tmem, "CUDA_TEMP_TABLE", path)
    argv = ["--arch", "internlm2_1_8b", "--reduced", "--device", "cpu", "--pipe-size", "4",
            "--m", "4", "--steps", "1", "--memory-budget-mb", "64"]
    launcher.main(argv + ["--seq-len", "64"])
    out = capsys.readouterr().out
    assert "measured at 2 layers at p=4, zb-h1, seq_len 64 (a card), scaled to this run\n" in out
    launcher.main(argv + ["--seq-len", "32"])
    out = capsys.readouterr().out
    assert ("measured at 2 layers at p=4, zb-h1 (a card), scaled to this run at seq 32: no record "
            "was measured at that sequence length") in out
