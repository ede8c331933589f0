"""Paper Table 3 model: gpt3_28_3b (layers=62 hidden=6144 heads=48 seq=1024)."""
import dataclasses

from ..models.lm import ArchConfig

CONFIG = ArchConfig(
    name="gpt3_28_3b",
    family="dense",
    n_layers=62,
    d_model=6144,
    n_heads=48,
    n_kv_heads=48,
    d_ff=4 * 6144,
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
