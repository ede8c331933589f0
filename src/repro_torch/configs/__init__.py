"""Architecture registry of the port: the configurations ported so far.

Each module exposes ``CONFIG`` (the exact published configuration) and
``reduced()`` (a tiny same-family config for CPU tests), as in
``src/repro/configs/``.  Input-shape cells are defined in ``shapes.py``.
The port carries every family of the JAX package: dense, moe (with the
``moe`` and ``mla`` kinds), vlm (the patch-embedding front), encdec (the
``encdec`` kind), ssm (the ``slstm`` and ``mlstm`` kinds) and hybrid (the
``rglru`` kind beside ``attn_local``): all ten of its assigned
architectures (``ARCH_IDS``) and the paper's models (``PAPER_IDS``).
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
    "xlstm_350m",
    "recurrentgemma_9b",
]

PAPER_IDS = ["gpt3_1_5b", "gpt3_6_2b", "gpt3_14_6b", "gpt3_28_3b"]

# the rest of the JAX package's assigned architectures: what each lacks here
# (none: every one is ported)
UNPORTED_ARCHS: Dict[str, str] = {}


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
