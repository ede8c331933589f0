"""Paper Table 3 model: gpt3_6_2b (layers=30 hidden=4096 heads=32 seq=1024)."""
import dataclasses

from ..models.lm import ArchConfig

CONFIG = ArchConfig(
    name="gpt3_6_2b",
    family="dense",
    n_layers=30,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    d_ff=4 * 4096,
    vocab=50257,
    block_pattern=(("attn", "mlp"),),
    dtype="bfloat16",
    source="ZB paper Table 3",
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=48, n_heads=4, n_kv_heads=4, d_ff=192,
        vocab=256, dtype="float32",
    )
