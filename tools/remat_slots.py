#!/usr/bin/env python3
"""What the port's remat keeps between F and B, measured on the CPU.

    PYTHONPATH=src python3 tools/remat_slots.py   # ~1 min

``models/modules.py::remat`` wraps the chunked attention's query blocks
and the mLSTM's chunkwise core, as the JAX package wraps them in
``jax.checkpoint``.  This script counts a block's residual as
``core/executor.py::slot_bytes`` counts a slot (its input, its output and
every tensor its F graph saves, each storage once, no parameter), with the
remat and without it (``remat`` replaced by a plain call), and prints one
JSON line per case:

* one mLSTM block of xlstm_350m at full width (d 1024, 4 heads, bf16),
  b=1, s=2048: both slots and what the block kept beyond the JAX remat's
  residuals (the core's inputs and its carries of C), as a share of the
  slot without the remat;
* one attn + mlp block of internlm2_1_8b at a narrow width (its reduced
  config, d 48, 4 heads, f32), b=1, at s from 1024 to 4608: the residual
  per token with and without the remat (the dense path, s <= 2048, has no
  remat to take).
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs import get_config, get_reduced  # noqa: E402
from repro_torch.core.executor import _storage_bytes  # noqa: E402
from repro_torch.models import modules as tmod  # noqa: E402
from repro_torch.models.lm import layer_cfg  # noqa: E402


def block_slot(kinds, cfg, s: int, plain: bool) -> float:
    """Bytes of one block's residual slot at b=1 and ``s`` tokens."""
    lc = layer_cfg(cfg)
    gen = torch.Generator().manual_seed(0)
    dtype = cfg.torch_dtype()
    params = tuple({k: v.requires_grad_() for k, v in
                    tmod.init_layer(k, gen, lc, tmod.ShardCtx(), dtype).items()} for k in kinds)
    x = torch.randn(1, s, cfg.d_model, generator=gen).to(dtype).requires_grad_()
    saved = []
    real = tmod.remat
    if plain:
        tmod.remat = lambda fn, tensors, *args: fn(*tensors, *args)
    try:
        with torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append(t) or t,
                                                      lambda t: t):
            y = tmod.apply_block(kinds, torch.tensor(1.0), params, x, torch.arange(s), lc,
                                 tmod.ShardCtx())
    finally:
        tmod.remat = real
    skip = {t.untyped_storage().data_ptr() for p in params for t in p.values()}
    return float(sum(_storage_bytes([x, y] + saved, skip).values()))


def main() -> int:
    torch.manual_seed(0)
    cfg = get_config("xlstm_350m")
    s, nh, dh = 2048, cfg.n_heads, cfg.d_model // cfg.n_heads
    plain, kept = block_slot(("mlstm",), cfg, s, True), block_slot(("mlstm",), cfg, s, False)
    carries = (-(-s // 128)) * nh * dh * dh * 2  # the JAX scan's C before each chunk, bf16
    beyond = plain - (kept + carries)
    print(json.dumps(dict(case="mlstm", arch=cfg.name, d_model=cfg.d_model, n_heads=nh, s=s,
                          dtype=cfg.dtype, slot_without_remat=plain, slot_with_remat=kept,
                          jax_carries=carries, beyond_jax_remat=beyond,
                          beyond_share=beyond / plain)))
    red = dataclasses.replace(get_reduced("internlm2_1_8b"), n_layers=1)
    for s in (1024, 2048, 2304, 3072, 4096, 4608):
        with_remat = block_slot(("attn", "mlp"), red, s, False)
        without = block_slot(("attn", "mlp"), red, s, True)
        print(json.dumps(dict(case="attn+mlp", arch=red.name, d_model=red.d_model,
                              n_heads=red.n_heads, s=s, per_token_with_remat=with_remat / s,
                              per_token_without_remat=without / s)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
