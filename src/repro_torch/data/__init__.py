"""Deterministic token data: the synthetic stream, a token file, prefetch (numpy)."""

from .pipeline import DataConfig, SyntheticLM, TokenFileLM, prefetch

__all__ = ["DataConfig", "SyntheticLM", "TokenFileLM", "prefetch"]
