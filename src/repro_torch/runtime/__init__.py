"""Fault-tolerant training driver and replanning of the port."""

from .driver import (
    DriverConfig,
    TrainDriver,
    rebalance_layers,
    replan_for_stragglers,
    replan_under_budget,
)

__all__ = [
    "DriverConfig",
    "TrainDriver",
    "replan_for_stragglers",
    "replan_under_budget",
    "rebalance_layers",
]
