"""Checkpoints of the port: the JAX package's on-disk layout."""

from .store import latest_step, reshard_stages, restore, save

__all__ = ["save", "restore", "latest_step", "reshard_stages"]
