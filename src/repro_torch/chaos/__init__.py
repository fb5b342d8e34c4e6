"""Chaos harness: seeded, schedule-driven fault injection over the fabric.

See ``repro_torch.chaos.inject`` and docs/architecture.md §9.
"""
from .inject import (
    BLACKHOLE,
    ChaosEvent,
    ChaosInjector,
    ChaosPlan,
    VirtualClock,
    node_matches,
)

__all__ = [
    "BLACKHOLE",
    "ChaosEvent",
    "ChaosInjector",
    "ChaosPlan",
    "VirtualClock",
    "node_matches",
]
