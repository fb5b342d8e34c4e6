"""Chunnel stacks: typed composition with Select alternatives (Bertha §3, §4.1).

``make_stack(a, b, c)`` composes top-down (a processes app data first; c is the
transport at the bottom). Entries may be Chunnels or Selects; Selects may nest,
so a stack denotes a *tree of concrete stacks* in preference order. Composition
is associative but not commutative.

Type checking happens at assembly time: adjacent WireTypes must match, else
``StackTypeError`` — the Python analogue of the paper's compile error.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Iterable, List, Optional, Sequence, Union

from repro_torch.core.capability import CapabilitySet
from repro_torch.core.chunnel import Chunnel, Datapath, WireType, types_match


class StackTypeError(TypeError):
    pass


@dataclass(frozen=True)
class Select:
    """Preference-ordered alternatives at one stack layer (Bertha §4.1).

    Unilateral selects swap locally; if any option is multilateral, switching
    requires negotiated agreement (§5)."""

    options: tuple  # of Entry (Chunnel | Select | tuple-of-Entry sub-stacks)

    def __init__(self, *options):
        object.__setattr__(self, "options", tuple(options))

    def __repr__(self):
        return "Select(" + " | ".join(map(repr, self.options)) + ")"


Entry = Union[Chunnel, Select, tuple]


def _expand(entry: Entry) -> List[List[Chunnel]]:
    """All concrete chunnel runs an entry can denote, in preference order."""
    if isinstance(entry, Chunnel):
        return [[entry]]
    if isinstance(entry, Select):
        out: List[List[Chunnel]] = []
        for opt in entry.options:
            out.extend(_expand(opt))
        return out
    if isinstance(entry, (tuple, list)):
        parts = [_expand(e) for e in entry]
        return [list(itertools.chain(*combo)) for combo in itertools.product(*parts)]
    raise TypeError(f"not a stack entry: {entry!r}")


class ConcreteStack:
    """A fully resolved chunnel sequence (one choice per Select)."""

    def __init__(self, chunnels: Sequence[Chunnel]):
        self.chunnels = list(chunnels)
        self.type_check()

    def type_check(self) -> None:
        for above, below in zip(self.chunnels, self.chunnels[1:]):
            if not types_match(above.lower_type, below.upper_type):
                raise StackTypeError(
                    f"{above.name} produces {above.lower_type} but "
                    f"{below.name} accepts {below.upper_type}"
                )

    def capabilities(self) -> CapabilitySet:
        caps = CapabilitySet()
        for c in self.chunnels:
            caps = caps.union_(c.capabilities())
        return caps

    def multilateral(self) -> bool:
        return any(c.multilateral for c in self.chunnels)

    def fingerprint(self) -> str:
        return "|".join(c.fingerprint() for c in self.chunnels)

    def instantiate(self) -> Datapath:
        """Recursive bottom-up connect_wrap (Bertha Fig. 2)."""
        dp: Optional[Datapath] = None
        for ch in reversed(self.chunnels):
            dp = ch.connect_wrap(dp)
        assert dp is not None, "empty stack"
        return dp

    def describe(self) -> list:
        return [
            {
                "name": c.name,
                "caps": c.capabilities().to_wire(),
                "upper": str(c.upper_type),
                "lower": str(c.lower_type),
                "multilateral": c.multilateral,
            }
            for c in self.chunnels
        ]

    def __repr__(self):
        return " -> ".join(c.name for c in self.chunnels)

    def __iter__(self):
        return iter(self.chunnels)

    def __len__(self):
        return len(self.chunnels)


class Stack:
    """A stack *specification*: chunnels and selects, top to bottom."""

    def __init__(self, *entries: Entry):
        self.entries = entries
        self._options: Optional[List[ConcreteStack]] = None
        if not self.options():
            raise StackTypeError("stack has no type-correct concrete option")

    def options(self) -> List[ConcreteStack]:
        """All type-correct concrete stacks, in developer preference order.

        Type-incorrect combinations are rejected here — the 'compile error'
        happens at assembly, before any connection exists. Entries are
        immutable, so the expansion + type-check cartesian product is
        computed once and memoized (preferred()/find()/offer() are hot on
        every negotiation round)."""
        if self._options is None:
            out = []
            for combo in _expand(tuple(self.entries)):
                try:
                    out.append(ConcreteStack(combo))
                except StackTypeError:
                    continue
            self._options = out
        return list(self._options)

    def preferred(self) -> ConcreteStack:
        return self.options()[0]

    def offer(self) -> list:
        """Wire form of all options (sent during negotiation §5.1)."""
        return [s.describe() for s in self.options()]

    def find(self, fingerprint: str) -> Optional[ConcreteStack]:
        for s in self.options():
            if s.fingerprint() == fingerprint:
                return s
        return None

    def __repr__(self):
        return "Stack(" + ", ".join(map(repr, self.entries)) + ")"


def make_stack(*entries: Entry) -> Stack:
    """Bertha's ``make_stack!`` macro."""
    return Stack(*entries)


def offered_capabilities(offer: list) -> List[CapabilitySet]:
    """Capability sets of each offered concrete stack (server side of §5.2)."""
    out = []
    for stack_desc in offer:
        caps = CapabilitySet()
        for ch in stack_desc:
            caps = caps.union_(CapabilitySet.from_wire(ch["caps"]))
        out.append(caps)
    return out
