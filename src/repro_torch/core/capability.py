"""Capabilities: relative-compatibility metadata for negotiation (Bertha §5.2).

Checking implementation equivalence is undecidable, so chunnels declare opaque
capability labels instead. Two match modes (as found sufficient in the paper):

  exact   — must be present in BOTH endpoints' stacks (e.g. serialization /
            wire format: both sides must speak it)
  compose — must be present in AT LEAST ONE stack (e.g. sharding / routing:
            one side doing it suffices)

Label convention "<feature>:<impl>" lets independent implementations declare
compatibility by reusing a label (the paper's ProtoBuf/ProtoACC example).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import FrozenSet, Iterable


@dataclass(frozen=True, order=True)
class Capability:
    label: str
    mode: str = "exact"  # "exact" | "compose"

    def __post_init__(self):
        assert self.mode in ("exact", "compose"), self.mode

    def __str__(self) -> str:
        return f"{self.label}/{self.mode}"

    def to_wire(self) -> dict:
        return {"label": self.label, "mode": self.mode}

    @staticmethod
    def from_wire(d: dict) -> "Capability":
        return Capability(d["label"], d["mode"])


class CapabilitySet(frozenset):
    """A frozenset of Capability with Bertha's two-mode comparison."""

    @staticmethod
    def exact(*labels: str) -> "CapabilitySet":
        return CapabilitySet(Capability(l, "exact") for l in labels)

    @staticmethod
    def compose(*labels: str) -> "CapabilitySet":
        return CapabilitySet(Capability(l, "compose") for l in labels)

    def union_(self, other: Iterable[Capability]) -> "CapabilitySet":
        return CapabilitySet(frozenset(self) | frozenset(other))

    def exact_labels(self) -> FrozenSet[str]:
        return frozenset(c.label for c in self if c.mode == "exact")

    def compose_labels(self) -> FrozenSet[str]:
        return frozenset(c.label for c in self if c.mode == "compose")

    def compatible_with(self, other: "CapabilitySet") -> bool:
        """§5.2: exact capabilities must match on both sides; compositional
        capabilities must appear in at least one side (always true if present
        anywhere — they never *block*; what blocks is an exact mismatch)."""
        return self.exact_labels() == other.exact_labels()

    def to_wire(self) -> list:
        return sorted((c.to_wire() for c in self), key=lambda d: (d["label"], d["mode"]))

    @staticmethod
    def from_wire(items: list) -> "CapabilitySet":
        return CapabilitySet(Capability.from_wire(d) for d in items)


def stack_compatible(a: CapabilitySet, b: CapabilitySet) -> bool:
    return a.compatible_with(b)
