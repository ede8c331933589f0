"""llava-next-mistral-7b: mistral backbone 32L d=4096 32H GQA kv=8 d_ff=14336.

The anyres vision front is a stub, as in the JAX package: the side inputs
carry precomputed patch embeddings (576 of ``frontend_dim`` 1024, one
336-pixel tile), and one learned projection ``front_proj`` maps them into
the text stream ahead of the tokens.
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]
"""
import dataclasses

from ..models.lm import ArchConfig

CONFIG = ArchConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=32000,
    block_pattern=(("attn", "mlp"),),
    extras=(("n_patches", 576), ("frontend_dim", 1024)),
    dtype="bfloat16",
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf",
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=48, n_heads=4, n_kv_heads=2, d_ff=96,
        vocab=256, extras=(("n_patches", 4), ("frontend_dim", 16)),
        dtype="float32",
    )
