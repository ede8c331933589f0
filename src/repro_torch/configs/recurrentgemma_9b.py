"""recurrentgemma-9b: 38 blocks d=4096 16H(kv=1) d_ff=12288 vocab=256k.

RG-LRU recurrent blocks + local attention, 2:1 pattern; sub-quadratic
(runs long_500k). [arXiv:2402.19427; unverified]
"""
import dataclasses

from ..models.lm import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    d_ff=12288,
    vocab=256000,
    block_pattern=(
        ("rglru", "mlp"), ("rglru", "mlp"), ("attn_local", "mlp"),
    ),
    extras=(("window", 2048), ("lru_width", 4096)),
    dtype="bfloat16",
    sub_quadratic=True,
    source="arXiv:2402.19427",
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, n_layers=3, d_model=48, n_heads=4, n_kv_heads=1, d_ff=96,
        vocab=256, extras=(("window", 8), ("lru_width", 48)), dtype="float32",
    )
