"""Architecture registry of the port: the configurations ported so far.

Each module exposes ``CONFIG`` (the exact published configuration) and
``reduced()`` (a tiny same-family config for CPU tests), as in
``src/repro/configs/``.  Input-shape cells are defined in ``shapes.py``.
The port carries the dense, moe (with the ``moe`` and ``mla`` kinds), vlm
(the patch-embedding front) and encdec (the ``encdec`` kind) families: of
the JAX package's assigned architectures those in ``ARCH_IDS``, and the
paper's models (``PAPER_IDS``).  The two recurrent ones raise
``NotImplementedError`` naming what they lack.
"""

from importlib import import_module
from typing import Dict

from ..models.lm import ArchConfig

__all__ = ["ARCH_IDS", "PAPER_IDS", "UNPORTED_ARCHS", "get_config", "get_reduced",
           "all_configs"]

# the JAX package's assigned architectures that the port carries, in its order
ARCH_IDS = [
    "whisper_tiny",
    "deepseek_v3_671b",
    "qwen2_moe_a2_7b",
    "deepseek_67b",
    "minitron_8b",
    "gemma2_2b",
    "internlm2_1_8b",
    "llava_next_mistral_7b",
]

PAPER_IDS = ["gpt3_1_5b", "gpt3_6_2b", "gpt3_14_6b", "gpt3_28_3b"]

# the rest of the JAX package's assigned architectures: what each lacks here
UNPORTED_ARCHS = {
    "xlstm_350m": "the ssm family (the slstm and mlstm kinds)",
    "recurrentgemma_9b": "the hybrid family (the rglru kind)",
}


def _module(arch_id: str):
    if arch_id in UNPORTED_ARCHS:
        raise NotImplementedError(
            f"arch {arch_id!r} is not ported to repro_torch yet: it needs "
            f"{UNPORTED_ARCHS[arch_id]}"
        )
    if arch_id not in ARCH_IDS + PAPER_IDS:
        raise ValueError(f"unknown arch {arch_id!r} (ported: {ARCH_IDS + PAPER_IDS})")
    return import_module(f".{arch_id}", __package__)


def get_config(arch_id: str) -> ArchConfig:
    return _module(arch_id).CONFIG


def get_reduced(arch_id: str) -> ArchConfig:
    return _module(arch_id).reduced()


def all_configs() -> Dict[str, ArchConfig]:
    return {a: get_config(a) for a in ARCH_IDS + PAPER_IDS}
