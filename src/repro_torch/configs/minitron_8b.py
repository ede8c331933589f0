"""minitron-8b: pruned nemotron, 32L d=4096 32H GQA kv=8 d_ff=16384 vocab=256k.

[arXiv:2407.14679; hf]
"""
import dataclasses

from ..models.lm import ArchConfig

CONFIG = ArchConfig(
    name="minitron-8b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=16384,
    vocab=256000,
    block_pattern=(("attn", "mlp"),),
    dtype="bfloat16",
    source="arXiv:2407.14679",
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=48, n_heads=4, n_kv_heads=2, d_ff=96,
        vocab=512, dtype="float32",
    )
