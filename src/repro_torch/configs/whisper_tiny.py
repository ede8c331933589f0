"""whisper-tiny: 4L enc + 4L dec, d=384, 6H, d_ff=1536, vocab 51865.

The conv audio front is a stub, as in the JAX package: the side inputs
carry precomputed frame embeddings (``s_enc`` 1500 of ``frontend_dim``
384), projected by ``front_proj`` ahead of the decoder's tokens.  Pipeline
layout: concat-carry (encoder positions, then decoder positions), 4 joint
``encdec`` blocks, each an encoder layer and a decoder layer gated by its
``enc_on`` / ``dec_on`` role scalars.  [arXiv:2212.04356; unverified]
"""
import dataclasses

from ..models.lm import ArchConfig

CONFIG = ArchConfig(
    name="whisper-tiny",
    family="encdec",
    n_layers=4,  # joint enc+dec blocks (4 enc || 4 dec, concat-carry)
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    d_ff=1536,
    vocab=51865,
    block_pattern=(("encdec",),),
    extras=(("s_enc", 1500), ("frontend_dim", 384)),
    dtype="bfloat16",
    source="arXiv:2212.04356",
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=32, n_heads=2, n_kv_heads=2, d_ff=64,
        vocab=128, extras=(("s_enc", 8), ("frontend_dim", 32)), dtype="float32",
    )
