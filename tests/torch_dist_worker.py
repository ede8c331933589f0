"""The rank processes of the port's multi-process tests (one process a
pipeline stage, gloo on the CPU).  No test is collected from here: the
tests start :func:`train_rank`, :func:`relay_rank` and :func:`sum_rank` through
``repro_torch.launch.mesh.spawn_ranks``, and the spawned processes import
this module alone (no JAX).

A job is a pickled dict; each rank writes its results, per case, to
``{out_dir}/{key}.rank{r}.pt``.
"""

import dataclasses
import pickle

import numpy as np
import torch

from repro_torch.configs import get_reduced
from repro_torch.core.executor import stage_slice
from repro_torch.core.schedules import compile_plan
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.interop import stage_share_from_numpy
from repro_torch.launch.mesh import init_pipe_group
from repro_torch.launch.steps import TrainStepConfig, build_stage_train_step
from repro_torch.launch.train import make_schedule, side_from_batch
from repro_torch.models.lm import RunSpec, init_params
from repro_torch.optim import adamw, postval

ARCH = "internlm2_1_8b"


def case_config(case):
    cfg = get_reduced(ARCH)
    if case.get("n_layers") is not None:
        cfg = dataclasses.replace(cfg, n_layers=case["n_layers"])
    return dataclasses.replace(cfg, dtype=case.get("dtype", cfg.dtype))


def case_plan(case, rank=None):
    """(schedule, plan) of a case; ``drop_send`` = (stage, tick) removes
    that send from the tables, on every rank or on ``drop_on`` alone."""
    sched = make_schedule(case["name"], case["p"], case["m"])
    plan = compile_plan(sched)
    if case.get("drop_send") is not None and rank in case.get("drop_on", [rank]):
        s, t = case["drop_send"]
        plan.send_channel = plan.send_channel.copy()
        plan.send_channel[s, t] = -1
    return sched, plan


def case_batches(cfg, spec, n):
    data = SyntheticLM(DataConfig(global_batch=spec.m * spec.microbatch, seq_len=spec.seq_len,
                                  vocab=cfg.vocab))
    return [data.batch_at(k) for k in range(n)]


def run_case(group, case):
    """Stage ``group.rank``'s run of one case: the step-0 walk on batch 0,
    then ``steps`` training steps from the same weights."""
    rank = group.rank
    cfg = case_config(case)
    sched, plan = case_plan(case, rank)
    spec = RunSpec(p=case["p"], n_chunks=sched.n_chunks, microbatch=case["b"],
                   seq_len=case["s"], m=case["m"])
    if case.get("jax_params") is not None:
        with open(case["jax_params"], "rb") as f:
            stacked_np, shared_np = pickle.load(f)[case["name"]]["init"]
        params, shared = stage_share_from_numpy(stacked_np, shared_np, rank, device="cpu")
    else:
        stacked, shared = init_params(cfg, spec, sched.placement, seed=case.get("seed", 0),
                                      device="cpu")
        params = stage_slice(stacked, rank)
        del stacked
    tcfg = TrainStepConfig(adamw=adamw.AdamWConfig(lr=case.get("lr", 3e-3),
                                                   grad_clip=case.get("clip", 1.0)),
                           postval_mode=case.get("postval", "within_step"))
    step, _ = build_stage_train_step(cfg, spec, plan, sched.placement, group, tcfg)
    decisions = []
    if case.get("log_decisions"):  # each optimistic decision this rank takes, in order
        decide = postval.decide_partial

        def logged(partial, acfg):
            dec = decide(partial, acfg)
            decisions.append(dec.applied)
            return dec

        postval.decide_partial = logged
    batches = case_batches(cfg, spec, max(1, case["steps"]))
    grads, shared_grads, loss = step.grad_fn(params, shared, side_from_batch(batches[0], spec,
                                                                             "cpu"))
    out = dict(grads=grads, shared_grads=shared_grads, loss=loss, metrics=[])
    opt, sopt = adamw.init(params), adamw.init(shared)
    for batch in batches[:case["steps"]]:
        params, shared, opt, sopt, met = step(params, shared, opt, sopt,
                                              side_from_batch(batch, spec, "cpu"))
        out["metrics"].append((float(met["loss"]), float(met["grad_norm"]), bool(met["amended"])))
    out.update(params=params, shared=shared, opt=tuple(opt), shared_opt=tuple(sopt),
               messages=step.grad_fn.transport.messages, decisions=decisions)
    return out


def train_rank(rank, world, init_method, job_path, out_dir):
    torch.set_num_threads(1)  # the suite's workers share the cores (tests/torch_threads.py)
    with open(job_path, "rb") as f:
        job = pickle.load(f)
    group = init_pipe_group(rank=rank, world=world, init_method=init_method, device="cpu",
                            timeout_s=job.get("timeout_s", 120.0))
    try:
        for case in job["cases"]:
            torch.save(run_case(group, case), f"{out_dir}/{case['key']}.rank{rank}.pt")
    finally:
        group.close()


def relay_rank(rank, world, init_method, stats_path, out_dir):
    """The post-validation relay alone: rank r's (sumsq, nonfinite) from
    ``stats_path`` (numpy (world, 2)); writes (partial, full, first)."""
    torch.set_num_threads(1)
    stats = np.load(stats_path)
    group = init_pipe_group(rank=rank, world=world, init_method=init_method, device="cpu",
                            timeout_s=60.0)
    try:
        mine = postval.GradStats(torch.tensor(stats[rank, 0], dtype=torch.float32),
                                 torch.tensor(bool(stats[rank, 1])))
        out = postval.relay_prefix_stats(group, mine)
        torch.save([tuple(st) for st in out], f"{out_dir}/relay.rank{rank}.pt")
    finally:
        group.close()


def sum_rank(rank, world, init_method, trees_path, out_dir):
    """``core/p2p.sum_in_stage_order`` alone: rank r's tree is entry r of
    the pickled list (numpy leaves); it is summed in pieces of 5 elements
    and written back."""
    torch.set_num_threads(1)
    with open(trees_path, "rb") as f:
        trees = pickle.load(f)
    group = init_pipe_group(rank=rank, world=world, init_method=init_method, device="cpu",
                            timeout_s=60.0)
    try:
        from repro_torch.core.p2p import sum_in_stage_order
        from repro_torch.tree import tree_map

        mine = tree_map(torch.from_numpy, trees[rank])
        torch.save(sum_in_stage_order(group, mine, chunk=5), f"{out_dir}/sum.rank{rank}.pt")
    finally:
        group.close()
