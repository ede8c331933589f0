"""qwen2-moe-a2.7b: 24L d=2048 16H, 4 shared + 60 routed top-4, d_ff/exp 1408.

[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]
"""
import dataclasses

from ..models.lm import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab=151936,
    block_pattern=(("attn", "moe"),),
    extras=(
        ("moe_d_ff", 1408), ("n_experts", 60), ("topk", 4),
        ("n_shared_experts", 4), ("capacity_factor", 1.25),
    ),
    dtype="bfloat16",
    source="hf:Qwen/Qwen1.5-MoE-A2.7B",
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=48,
        vocab=256,
        extras=(
            ("moe_d_ff", 48), ("n_experts", 6), ("topk", 2),
            ("n_shared_experts", 2), ("capacity_factor", 1.5),
        ),
        dtype="float32",
    )
