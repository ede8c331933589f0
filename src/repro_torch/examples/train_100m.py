"""End-to-end driver: train a ~100M-param GPT through the ZB pipeline.

Default: 4 pipeline stages on one device (the CUDA card; ``--device cpu``
asks for the CPU), ZB-H2 schedule, synthetic next-token stream,
checkpoint/restart via the fault-tolerant driver.

  python -m repro_torch.examples.train_100m --steps 300     # full run

Counterpart of ``examples/train_100m.py``: the same config, registered
inline as the JAX example registers it, through the port's
``launch/train.py::main`` with the JAX example's arguments.  Run again
with the same ``--ckpt-dir``, it resumes from the newest checkpoint there.
The launcher checks that the loss fell over the run: at lr 1e-3 with no
warm-up on the 32768-token vocabulary it first does after ~130 steps, so
the JAX example's 5-step smoke fails that check, in both packages.
"""

from __future__ import annotations

import argparse
import os
import tempfile
from typing import Optional, Sequence

from ..models.lm import ArchConfig

__all__ = ["gpt_100m", "main"]


def gpt_100m() -> ArchConfig:
    # ~101M params: 10 x (12 d^2) + 2 V d = 10*12*640^2 + 2*32768*640
    return ArchConfig(
        name="gpt-100m", family="dense", n_layers=10, d_model=640,
        n_heads=10, n_kv_heads=10, d_ff=2560, vocab=32768,
        block_pattern=(("attn", "mlp"),), dtype="float32",
        source="examples/train_100m",
    )


def main(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--schedule", default="zb-h2")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_100m_ckpt"))
    args = ap.parse_args(argv)

    # register the config inline and reuse the generic launcher
    from ..launch import train as T

    cfg = gpt_100m()
    n_params = 10 * 12 * 640 * 640 + 2 * 32768 * 640
    print(f"model: {cfg.name} (~{n_params / 1e6:.0f}M params)")

    orig_get = T.get_config
    T.get_config = lambda a: cfg if a == "gpt-100m" else orig_get(a)
    try:
        res = T.main([
            "--arch", "gpt-100m", "--pipe-size", "4",
            "--schedule", args.schedule, "--microbatch", "1", "--seq-len", "256",
            "--m", "8", "--steps", str(args.steps), "--lr", "1e-3",
            "--ckpt-dir", args.ckpt_dir, "--device", args.device,
        ])
    finally:
        T.get_config = orig_get
    print("OK")
    return res


if __name__ == "__main__":
    main()
