"""Input-shape cells for the dry run: 4 shapes x the ported architectures.

Counterpart of ``src/repro/configs/shapes.py``, over the port's ``ARCH_IDS``:

  train_4k     seq 4096,    global_batch 256  -> train_step
  prefill_32k  seq 32768,   global_batch 32   -> serve prefill
  decode_32k   seq 32768 KV, global_batch 128 -> serve decode (1 new token)
  long_500k    seq 524288 KV, global_batch 1  -> long-context decode
                (sub-quadratic archs only; skips recorded per arch)
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

from . import ARCH_IDS, get_config

__all__ = ["ShapeCell", "SHAPES", "cells_for", "all_cells"]


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    shape_id: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}


def cells_for(arch_id: str) -> List[Tuple[str, ShapeCell, Optional[str]]]:
    """(shape_id, cell, skip_reason) for one arch; skipped cells are still
    listed, with the reason."""
    cfg = get_config(arch_id)
    out = []
    for sid, cell in SHAPES.items():
        skip = None
        if sid == "long_500k" and not cfg.sub_quadratic:
            skip = "full-attention arch: 500k decode is quadratic (DESIGN.md Sec. 5)"
        if cell.kind == "decode" and not cfg.has_decoder:
            skip = "encoder-only arch has no decode step"
        out.append((sid, cell, skip))
    return out


def all_cells():
    for a in ARCH_IDS:
        for sid, cell, skip in cells_for(a):
            yield a, sid, cell, skip
