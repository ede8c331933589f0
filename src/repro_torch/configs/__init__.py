"""Architecture registry of the port: the configurations ported so far.

Each module exposes ``CONFIG`` (the exact published configuration) and
``reduced()`` (a tiny same-family config for CPU tests), as in
``src/repro/configs/``.
"""

from importlib import import_module

from ..models.lm import ArchConfig

__all__ = ["ARCH_IDS", "get_config", "get_reduced"]

ARCH_IDS = ["internlm2_1_8b"]


def _module(arch_id: str):
    if arch_id not in ARCH_IDS:
        raise NotImplementedError(
            f"arch {arch_id!r} is not ported to repro_torch yet (ported: {ARCH_IDS})"
        )
    return import_module(f".{arch_id}", __package__)


def get_config(arch_id: str) -> ArchConfig:
    return _module(arch_id).CONFIG


def get_reduced(arch_id: str) -> ArchConfig:
    return _module(arch_id).reduced()
