"""The JAX package's multi-device training step or post-validation relay on
fake CPU devices, for the port's multi-process tests; run as a script in a
process of its own, since the device count is fixed before JAX starts:

    python tests/torch_jax_pipe_ref.py train OUT.pkl P M B S STEPS N_LAYERS SCHEDULE...
    python tests/torch_jax_pipe_ref.py relay OUT.npy STATS.npy

``train``: the launcher's step (``repro.launch.steps.build_train_step`` on a
P-device mesh, executor ``unroll``, no donation) under each schedule from
the ``init_params`` weights of its placement, STEPS steps on the seeded
synthetic stream; pickles {schedule: {"init": (stacked, shared), "metrics":
[(loss, grad_norm, amended)], "final": (stacked, shared)}} as numpy trees.
``relay``: ``repro.optim.postval.pipe_prefix_stats`` under ``shard_map`` on
as many devices as STATS.npy has rows ((sumsq, nonfinite) a stage); saves
(partial sumsq, partial nonfinite, full sumsq, full nonfinite) a stage.
"""

import os
import pickle
import sys

import numpy as np


def _devices(n: int) -> None:
    os.environ["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={n}"
    os.environ.setdefault("JAX_PLATFORMS", "cpu")


def train(out, p, m, b, s, steps, n_layers, names):
    _devices(p)
    import dataclasses

    import jax
    import jax.numpy as jnp

    from repro.configs import get_reduced
    from repro.core.schedules import compile_plan
    from repro.data import DataConfig, SyntheticLM
    from repro.launch.mesh import AxisBinding
    from repro.launch.steps import TrainStepConfig, build_train_step
    from repro.launch.train import SCHEDULES, side_from_batch
    from repro.models.lm import RunSpec, init_params
    from repro.optim import adamw

    cfg = dataclasses.replace(get_reduced("internlm2_1_8b"), n_layers=n_layers)
    mesh = jax.make_mesh((p,), ("data",))
    tcfg = TrainStepConfig(adamw=adamw.AdamWConfig(lr=3e-3), postval_mode="within_step",
                           executor_mode="unroll", donate=False)
    host = lambda tree: jax.tree_util.tree_map(np.asarray, jax.device_get(tree))  # noqa: E731
    results = {}
    for name in names:
        sched = SCHEDULES[name](p, m)
        spec = RunSpec(p=p, n_chunks=sched.n_chunks, microbatch=b, seq_len=s, m=m)
        make, _ = build_train_step(cfg, spec, compile_plan(sched), sched.placement, mesh,
                                   AxisBinding(pipe="data", tp=None, dp=None), tcfg)
        stacked, shared = init_params(cfg, spec, sched.placement)
        init = host((stacked, shared))
        zeros = lambda t: jax.tree_util.tree_map(  # noqa: E731
            lambda a: jnp.zeros(a.shape, jnp.float32), t)
        opt = adamw.AdamWState(t=jnp.zeros((), jnp.int32), m=zeros(stacked), v=zeros(stacked))
        sopt = adamw.AdamWState(t=jnp.zeros((), jnp.int32), m=zeros(shared), v=zeros(shared))
        data = SyntheticLM(DataConfig(global_batch=m * b, seq_len=s, vocab=cfg.vocab))
        step, metrics = None, []
        for k in range(steps):
            side = side_from_batch(data.batch_at(k), spec, cfg=cfg)
            step = step or make(side)
            stacked, shared, opt, sopt, met = step(stacked, shared, opt, sopt, side)
            met = host(met)
            metrics.append((float(met["loss"]), float(met["grad_norm"]), bool(met["amended"])))
        results[name] = dict(init=init, metrics=metrics, final=host((stacked, shared)))
    with open(out, "wb") as f:
        pickle.dump(results, f)


def relay(out, stats_path):
    stats = np.load(stats_path)
    p = stats.shape[0]
    _devices(p)
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from repro.optim.postval import GradStats, pipe_prefix_stats

    def body(sq, bad):
        partial, full = pipe_prefix_stats(GradStats(sq[0], bad[0]), "pipe")
        return (jnp.stack([partial.sumsq, partial.nonfinite.astype(jnp.float32),
                           full.sumsq, full.nonfinite.astype(jnp.float32)])[None])

    mesh = jax.make_mesh((p,), ("pipe",))
    fn = jax.shard_map(body, mesh=mesh, in_specs=(P("pipe"), P("pipe")), out_specs=P("pipe"),
                       check_vma=False)
    got = jax.jit(fn)(jnp.asarray(stats[:, 0], jnp.float32), jnp.asarray(stats[:, 1] > 0.5))
    np.save(out, np.asarray(jax.device_get(got)))


if __name__ == "__main__":
    if sys.argv[1] == "train":
        out, p, m, b, s, steps, n_layers, *names = sys.argv[2:]
        train(out, int(p), int(m), int(b), int(s), int(steps), int(n_layers), names)
    else:
        relay(sys.argv[2], sys.argv[3])
