"""xlstm-350m: 24 blocks d=1024 4H, sLSTM + mLSTM mix (xLSTM[7:1]-ish),
d_ff=0 (blocks carry their own projections), vocab 50304.

Sub-quadratic: runs long_500k. [arXiv:2405.04517; unverified]
"""
import dataclasses

from ..models.lm import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-350m",
    family="ssm",
    n_layers=24,
    d_model=1024,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab=50304,
    block_pattern=(
        ("mlstm",), ("mlstm",), ("mlstm",), ("slstm",),
    ),
    dtype="bfloat16",
    sub_quadratic=True,
    source="arXiv:2405.04517",
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, n_layers=4, d_model=32, n_heads=2, n_kv_heads=2, vocab=256,
        dtype="float32",
    )
