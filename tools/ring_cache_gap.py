#!/usr/bin/env python3
"""How far each package's ``attn_local`` decode lands from its forward.

    PYTHONPATH=src python3 tools/ring_cache_gap.py     # on the CPU, seconds

Reduced gemma2 (window W = 8, float32), one ``attn_local`` layer with the
JAX ``init_layer`` weights (carried over to the port): for each prompt
length s, prefill s tokens into a cache for s + 1, decode token s, and
print one JSON line with the max abs error of the JAX package's decode and
of the port's against the last row of the JAX ``apply_attn`` over all s + 1
tokens.  A ring shorter than the prompt keeps the prompt's last W
positions; the JAX prefill stores them from slot 0, the port in slot
``P % W``, where both decodes look for position P.
"""

from __future__ import annotations

import json
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

from repro.models import modules as jmod  # noqa: E402
from repro.models import serve as jserve  # noqa: E402

from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.interop import to_torch  # noqa: E402
from repro_torch.models import modules as tmod  # noqa: E402
from repro_torch.models import serve as tserve  # noqa: E402
from repro_torch.models.lm import layer_cfg  # noqa: E402

KIND = "attn_local"


def gaps(s: int, seed: int = 0, b: int = 2) -> dict:
    cfg = layer_cfg(get_reduced("gemma2_2b"))
    pj = jmod.init_layer(KIND, jax.random.PRNGKey(seed), cfg, jmod.ShardCtx(), jnp.float32)
    pt = {k: to_torch(np.asarray(v)) for k, v in pj.items()}
    x = np.random.default_rng(seed + 1).standard_normal((b, s + 1, cfg["d_model"]))
    x = x.astype(np.float32)
    want = np.asarray(jmod.apply_layer(KIND, pj, jnp.asarray(x), jnp.arange(s + 1), cfg,
                                       jmod.ShardCtx()))[:, s:]

    jctx = jmod.ShardCtx()
    jcache = jserve.cache_spec(KIND, cfg, jctx, b, s + 1, jnp.float32)
    _, jcache = jserve.prefill_block(KIND, pj, jnp.asarray(x[:, :s]), jcache, cfg, jctx,
                                     jnp.arange(s))
    y_j, _ = jserve.decode_block(KIND, pj, jnp.asarray(x[:, s:]), jcache, s, cfg, jctx)

    tctx = tmod.ShardCtx()
    tcache = tserve.cache_spec(KIND, cfg, tctx, b, s + 1, torch.float32, device="cpu")
    head, last = (torch.from_numpy(np.ascontiguousarray(a)) for a in (x[:, :s], x[:, s:]))
    tserve.prefill_block(KIND, pt, head, tcache, cfg, tctx, torch.arange(s))
    y_t, _ = tserve.decode_block(KIND, pt, last, tcache, s, cfg, tctx)
    return dict(prompt=s, window=cfg["window"], ring=int(tcache["k"].shape[1]),
                jax_decode_max_abs=float(np.abs(np.asarray(y_j) - want).max()),
                port_decode_max_abs=float(np.abs(y_t.numpy() - want).max()))


def main() -> int:
    w = layer_cfg(get_reduced("gemma2_2b"))["window"]
    for s in (w - 2, w, w + 2, 2 * w, 2 * w + 3):
        print(json.dumps(gaps(s)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
