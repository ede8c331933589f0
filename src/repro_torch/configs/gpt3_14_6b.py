"""Paper Table 3 model: gpt3_14_6b (layers=46 hidden=5120 heads=40 seq=1024)."""
import dataclasses

from ..models.lm import ArchConfig

CONFIG = ArchConfig(
    name="gpt3_14_6b",
    family="dense",
    n_layers=46,
    d_model=5120,
    n_heads=40,
    n_kv_heads=40,
    d_ff=4 * 5120,
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
