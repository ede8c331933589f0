"""Paper Table 3 model: gpt3_1_5b (layers=22 hidden=2304 heads=24 seq=1024)."""
import dataclasses

from ..models.lm import ArchConfig

CONFIG = ArchConfig(
    name="gpt3_1_5b",
    family="dense",
    n_layers=22,
    d_model=2304,
    n_heads=24,
    n_kv_heads=24,
    d_ff=4 * 2304,
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
