"""Deterministic token data pipeline, copied from
``src/repro/data/pipeline.py`` (numpy only, so both packages draw the same
batches): the seeded synthetic stream, a memory-mapped token file, and a
host-side prefetch thread.  Each batch is {tokens, labels: (global_batch,
seq)} with labels = next-token shift; the batch at step k is a pure
function of (seed, k), or of the file and k.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator

import numpy as np

__all__ = ["DataConfig", "SyntheticLM", "TokenFileLM", "prefetch"]


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


class TokenFileLM:
    """Memory-mapped flat token file (np.int32), strided into sequences:
    sequence i is tokens [i * seq_len, (i + 1) * seq_len + 1), and step k
    reads sequences k * global_batch, ... modulo their number."""

    def __init__(self, path: str, cfg: DataConfig):
        self.cfg = cfg
        self.tokens = np.memmap(path, dtype=np.int32, mode="r")
        self.n_seq = (len(self.tokens) - 1) // cfg.seq_len

    def batch_at(self, step: int) -> dict:
        cfg = self.cfg
        idx = (np.arange(cfg.global_batch) + step * cfg.global_batch) % self.n_seq
        starts = idx * cfg.seq_len
        toks = np.stack([self.tokens[s : s + cfg.seq_len + 1] for s in starts])
        return {
            "tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32),
        }

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


def prefetch(it: Iterator, depth: int = 2) -> Iterator:
    """Host-side prefetch thread (overlaps batch prep with device steps):
    the items of ``it`` in order, up to ``depth`` of them made ahead.  An
    exception that ``it`` raises is raised again here, after the items
    before it; the JAX version ends the stream there without one."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = object()
    failed = []

    def worker():
        try:
            for item in it:
                q.put(item)
        except BaseException as e:  # noqa: BLE001 -- handed to the consumer
            failed.append(e)
        finally:
            q.put(stop)

    threading.Thread(target=worker, daemon=True).start()
    while True:
        item = q.get()
        if item is stop:
            if failed:
                raise failed[0]
            return
        yield item
