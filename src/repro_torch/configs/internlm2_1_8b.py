"""internlm2-1.8b: 24L d=2048 16H GQA kv=8 d_ff=8192 vocab=92544.

[arXiv:2403.17297; hf]
"""
import dataclasses

from ..models.lm import ArchConfig

CONFIG = ArchConfig(
    name="internlm2-1.8b",
    family="dense",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_ff=8192,
    vocab=92544,
    block_pattern=(("attn", "mlp"),),
    dtype="bfloat16",
    source="arXiv:2403.17297",
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=48, n_heads=4, n_kv_heads=2, d_ff=96,
        vocab=256, dtype="float32",
    )
