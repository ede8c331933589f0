"""deepseek-67b: dense llama-arch, 95L d=8192 64H GQA kv=8 d_ff=22016.

[arXiv:2401.02954; hf]
"""
import dataclasses

from ..models.lm import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-67b",
    family="dense",
    n_layers=95,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22016,
    vocab=102400,
    block_pattern=(("attn", "mlp"),),
    dtype="bfloat16",
    source="arXiv:2401.02954",
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, n_layers=3, d_model=64, n_heads=8, n_kv_heads=2, d_ff=128,
        vocab=256, dtype="float32",
    )
