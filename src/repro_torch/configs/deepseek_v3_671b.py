"""deepseek-v3-671b: 61L d=7168 128H MLA, MoE 1 shared + 256 routed top-8.

d_ff here is the per-expert FF (2048); dense d_ff (first layers) 18432.
MTP omitted (optional head). [arXiv:2412.19437; hf]
"""
import dataclasses

from ..models.lm import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-v3-671b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    d_ff=2048,
    vocab=129280,
    head_dim=128,
    block_pattern=(("mla", "moe"),),
    extras=(
        ("moe_d_ff", 2048), ("n_experts", 256), ("topk", 8),
        ("n_shared_experts", 1), ("capacity_factor", 1.25),
        ("q_lora_rank", 1536), ("kv_lora_rank", 512), ("qk_rope_head_dim", 64),
    ),
    dtype="bfloat16",
    source="arXiv:2412.19437",
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=64,
        head_dim=16, vocab=256,
        extras=(
            ("moe_d_ff", 32), ("n_experts", 8), ("topk", 2),
            ("n_shared_experts", 1), ("capacity_factor", 1.5),
            ("q_lora_rank", 32), ("kv_lora_rank", 16), ("qk_rope_head_dim", 8),
        ),
        dtype="float32",
    )
