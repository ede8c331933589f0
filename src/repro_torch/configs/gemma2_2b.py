"""gemma2-2b: 26L d=2304 8H GQA kv=4 d_ff=9216 vocab=256k.

Local(4096)/global alternating attention + logit softcap.
long_500k SKIPPED: global layers are full attention (quadratic).
[arXiv:2408.00118; hf]
"""
import dataclasses

from ..models.lm import ArchConfig

CONFIG = ArchConfig(
    name="gemma2-2b",
    family="dense",
    n_layers=26,
    d_model=2304,
    n_heads=8,
    n_kv_heads=4,
    d_ff=9216,
    vocab=256000,
    block_pattern=(("attn_local", "mlp"), ("attn", "mlp")),
    extras=(("window", 4096), ("attn_softcap", 50.0)),
    dtype="bfloat16",
    source="arXiv:2408.00118",
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=48, n_heads=4, n_kv_heads=2, d_ff=96,
        vocab=256, extras=(("window", 8), ("attn_softcap", 50.0)),
        dtype="float32",
    )
