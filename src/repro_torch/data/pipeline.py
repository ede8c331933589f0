"""Deterministic synthetic token stream, copied from
``src/repro/data/pipeline.py`` (numpy only, so both packages draw the same
batches).  Each batch is {tokens, labels: (global_batch, seq)} with labels =
next-token shift; the batch at step k is a pure function of (seed, k).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np

__all__ = ["DataConfig", "SyntheticLM"]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    global_batch: int
    seq_len: int
    vocab: int
    seed: int = 0


class SyntheticLM:
    """Seeded synthetic LM stream: batch at step k is a pure function of
    (seed, k) -- restartable from any step without replay."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg

    def batch_at(self, step: int) -> dict:
        cfg = self.cfg
        rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, step]))
        # noisy successor chain: strongly learnable bigram structure so short
        # smoke runs show a clear loss decrease
        n, s = cfg.global_batch, cfg.seq_len + 1
        toks = np.empty((n, s), np.int64)
        toks[:, 0] = rng.integers(0, cfg.vocab, size=n)
        noise = rng.random((n, s - 1)) < 0.15
        jumps = rng.integers(0, cfg.vocab, size=(n, s - 1))
        for t in range(1, s):
            nxt = (toks[:, t - 1] + 1) % cfg.vocab
            toks[:, t] = np.where(noise[:, t - 1], jumps[:, t - 1], nxt)
        return {
            "tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32),
        }

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
