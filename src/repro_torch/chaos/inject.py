"""Fault injection over the host fabric (ROADMAP direction 5).

A ``ChaosPlan`` is a seeded, declarative schedule of network faults —
partitions, link degradation, endpoint crash/restart, arbitrary callbacks —
expressed against *node prefixes*: an event naming node ``"b"`` hits every
endpoint whose address is ``"b"`` or starts with ``"b/"``, so a HostAgent's
``/ctrl`` and ``/resync`` endpoints go down with the agent.  Events fire
either at a schedule time relative to ``ChaosInjector.start()`` (driven by
``poll``) or on a named trigger (``fire``), which is how a scenario pauses
the 2PC coordinator *exactly* mid-commit: hang the crash on a trigger and
pull it from the commit hook.

A ``ChaosInjector`` binds a plan to a ``Fabric`` using only the control
plane (``set_link`` / ``clear_link`` / the registration hook) — the
batched data path never sees the injector.  Crashes are modeled as
blackhole isolation (loss=1.0 on every link to and from the node) rather
than endpoint unregistration, so agents keep their endpoint objects across
a crash/restart cycle, exactly like a process that freezes and thaws.
Every mutation saves the pair's previous override, so ``heal``/``restart``
restores what the pair had before (including an earlier ``degrade``);
overlapping faults on the same pair must therefore heal LIFO.  A
registration hook re-applies active faults to endpoints that appear
mid-fault, so a crashed node cannot "escape" by registering a new address.

Determinism: the plan's schedule is fixed up front (``churn`` draws its
victims from the plan's seeded RNG at build time), and ``poll``/``start``
accept an explicit ``now`` so tests can drive the whole schedule on a
``VirtualClock``.
"""
from __future__ import annotations

import bisect
import itertools
import threading
import time
import random
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

from repro_torch.core.fabric import Fabric, LinkModel
from repro_torch.obs.trace import TRACER

#: total isolation — applied per-pair for partitions and crashes
BLACKHOLE = LinkModel(latency_s=0.0, jitter_s=0.0, loss=1.0)

Nodes = Union[str, Sequence[str]]


def _as_nodes(nodes: Nodes) -> Tuple[str, ...]:
    if isinstance(nodes, str):
        return (nodes,)
    return tuple(nodes)


def node_matches(addr: str, nodes: Sequence[str]) -> bool:
    """Prefix match: node "b" owns endpoint "b" and every "b/..." child."""
    for n in nodes:
        if addr == n or addr.startswith(n + "/"):
            return True
    return False


@dataclass(frozen=True)
class ChaosEvent:
    """One scheduled fault. ``at_s`` is relative to ``ChaosInjector.start``;
    ``on`` names a trigger instead. ``target`` (heal/restart only) is the
    label of the event to undo. ``for_s`` auto-schedules the heal."""

    kind: str                     # partition | degrade | crash | heal | call
    label: str
    at_s: Optional[float] = None
    on: Optional[str] = None
    a: Tuple[str, ...] = ()
    b: Tuple[str, ...] = ()
    link: Optional[LinkModel] = None
    fn: Optional[Callable[[], None]] = None
    symmetric: bool = True
    target: Optional[str] = None
    for_s: Optional[float] = None


class ChaosPlan:
    """A deterministic fault schedule, built one call per event.

    Every plan method returns the event's label (auto-generated when not
    given) so later ``heal``/``restart`` calls can reference it.  Exactly one
    of ``at`` (seconds after injector start) or ``on`` (trigger name) must be
    set per event.
    """

    def __init__(self, seed: int = 0):
        self.seed = seed
        self.rng = random.Random(seed)
        self.events: List[ChaosEvent] = []
        self._counter = itertools.count(1)

    def _add(self, ev: ChaosEvent) -> str:
        if (ev.at_s is None) == (ev.on is None):
            raise ValueError(f"{ev.kind} {ev.label!r}: exactly one of at/on")
        self.events.append(ev)
        return ev.label

    def _label(self, kind: str, label: Optional[str]) -> str:
        return label if label is not None else f"{kind}-{next(self._counter)}"

    def partition(self, a: Nodes, b: Nodes, *, at: Optional[float] = None,
                  on: Optional[str] = None, label: Optional[str] = None,
                  for_s: Optional[float] = None) -> str:
        """Blackhole every link crossing the (a, b) cut, both directions."""
        return self._add(ChaosEvent(
            kind="partition", label=self._label("partition", label),
            at_s=at, on=on, a=_as_nodes(a), b=_as_nodes(b), for_s=for_s))

    def degrade(self, a: Nodes, b: Nodes, link: LinkModel, *,
                at: Optional[float] = None, on: Optional[str] = None,
                label: Optional[str] = None, symmetric: bool = True,
                for_s: Optional[float] = None) -> str:
        """Override every (a, b)-crossing link with ``link`` (WAN weather)."""
        return self._add(ChaosEvent(
            kind="degrade", label=self._label("degrade", label),
            at_s=at, on=on, a=_as_nodes(a), b=_as_nodes(b), link=link,
            symmetric=symmetric, for_s=for_s))

    def crash(self, node: Nodes, *, at: Optional[float] = None,
              on: Optional[str] = None, label: Optional[str] = None,
              for_s: Optional[float] = None) -> str:
        """Isolate a node (and all its child endpoints) from everyone else."""
        return self._add(ChaosEvent(
            kind="crash", label=self._label("crash", label),
            at_s=at, on=on, a=_as_nodes(node), for_s=for_s))

    def heal(self, target_label: str, *, at: Optional[float] = None,
             on: Optional[str] = None) -> str:
        """Undo a previously applied event, restoring saved link state."""
        return self._add(ChaosEvent(
            kind="heal", label=self._label("heal", None),
            at_s=at, on=on, target=target_label))

    def restart(self, target_label: str, *, at: Optional[float] = None,
                on: Optional[str] = None) -> str:
        """Bring a crashed node back (alias of ``heal`` for crash labels)."""
        return self.heal(target_label, at=at, on=on)

    def call(self, fn: Callable[[], None], *, at: Optional[float] = None,
             on: Optional[str] = None, label: Optional[str] = None) -> str:
        """Run an arbitrary callback at a schedule point (e.g. stop a member's
        poll loop to model a process hang the fabric can't express)."""
        return self._add(ChaosEvent(
            kind="call", label=self._label("call", label), at_s=at, on=on,
            fn=fn))

    def churn(self, nodes: Sequence[str], *, start_s: float, period_s: float,
              down_s: float, rounds: int) -> List[str]:
        """Seeded rolling churn: every ``period_s`` one plan-RNG-chosen node
        crashes for ``down_s`` then restarts. Same seed ⇒ same victims."""
        if down_s >= period_s:
            raise ValueError("down_s must be < period_s (one victim at a time)")
        labels: List[str] = []
        t = start_s
        for r in range(rounds):
            victim = self.rng.choice(list(nodes))
            lab = self.crash(victim, at=t, label=f"churn{r + 1}-{victim}",
                             for_s=down_s)
            labels.append(lab)
            t += period_s
        return labels


class ChaosInjector:
    """Applies a ``ChaosPlan`` to a ``Fabric``: timed events via ``poll``
    (caller-pumped, virtual-time friendly), trigger events via ``fire``.
    ``stop()`` heals everything still active (LIFO) and unhooks."""

    def __init__(self, fabric: Fabric, plan: ChaosPlan):
        self.fabric = fabric
        self.plan = plan
        self._lock = threading.Lock()
        self._t0: Optional[float] = None
        # timed queue kept sorted by (at_s, insertion order)
        timed = [ev for ev in plan.events if ev.at_s is not None]
        self._timed: List[Tuple[float, int, ChaosEvent]] = sorted(
            (ev.at_s, i, ev) for i, ev in enumerate(timed))
        self._next_ord = itertools.count(len(plan.events))
        self._triggers: Dict[str, List[ChaosEvent]] = {}
        for ev in plan.events:
            if ev.on is not None:
                self._triggers.setdefault(ev.on, []).append(ev)
        self._active: Dict[str, ChaosEvent] = {}  # label -> applied link event
        self._saved: Dict[str, Dict[Tuple[str, str],
                                    Optional[LinkModel]]] = {}
        self.log: List[dict] = []
        self.applied = 0
        self._hooked = False

    # -- lifecycle ---------------------------------------------------------------
    def start(self, now: Optional[float] = None) -> "ChaosInjector":
        with self._lock:
            if self._t0 is not None:
                raise RuntimeError("injector already started")
            self._t0 = time.monotonic() if now is None else now
            self._hooked = True
        self.fabric.add_register_hook(self._on_register)
        return self

    def stop(self) -> None:
        """Heal every active fault (LIFO) and detach from the fabric."""
        with self._lock:
            labels = list(reversed(list(self._active)))
            hooked, self._hooked = self._hooked, False
        for lab in labels:
            self._apply(ChaosEvent(kind="heal", label=f"stop:{lab}",
                                   target=lab), t=None)
        if hooked:
            self.fabric.remove_register_hook(self._on_register)

    def active_labels(self) -> List[str]:
        with self._lock:
            return list(self._active)

    # -- driving -----------------------------------------------------------------
    def poll(self, now: Optional[float] = None) -> int:
        """Apply every timed event whose at_s has passed; returns the count.
        Pass ``now`` explicitly (e.g. a VirtualClock reading) for virtual
        time; otherwise ``time.monotonic()`` is used."""
        with self._lock:
            if self._t0 is None:
                raise RuntimeError("injector not started")
            t = (time.monotonic() if now is None else now) - self._t0
            due: List[ChaosEvent] = []
            while self._timed and self._timed[0][0] <= t:
                due.append(self._timed.pop(0)[2])
        for ev in due:
            self._apply(ev, t)
        return len(due)

    def fire(self, trigger: str) -> int:
        """Apply every event hung on ``trigger`` immediately."""
        with self._lock:
            if self._t0 is None:
                raise RuntimeError("injector not started")
            t = time.monotonic() - self._t0
            due = self._triggers.pop(trigger, [])
        for ev in due:
            self._apply(ev, t)
        return len(due)

    # -- application -------------------------------------------------------------
    def _apply(self, ev: ChaosEvent, t: Optional[float]) -> None:
        if ev.kind == "call":
            fn = ev.fn
            if fn is not None:
                fn()  # user callback: never under the injector lock
            self._record(ev, t)
            return
        if ev.kind == "heal":
            restored = self._heal(ev.target)
            self._record(ev, t, restored=restored, target=ev.target)
            return
        with self._lock:
            n_pairs = self._apply_link_event(ev)
            if ev.for_s is not None and t is not None:
                heal = ChaosEvent(kind="heal", label=f"autoheal:{ev.label}",
                                  at_s=t + ev.for_s, target=ev.label)
                bisect.insort(self._timed,
                              (heal.at_s, next(self._next_ord), heal))
        self._record(ev, t, pairs=n_pairs)

    def _apply_link_event(self, ev: ChaosEvent) -> int:
        """Under self._lock: blackhole/degrade every crossing pair, saving the
        previous override of each pair the first time this label touches it."""
        eps = self.fabric.endpoints()
        pairs = _event_pairs(ev, eps)
        saved = self._saved.setdefault(ev.label, {})
        model = ev.link if ev.kind == "degrade" else BLACKHOLE
        for s, d in pairs:
            if (s, d) not in saved:
                saved[(s, d)] = self.fabric.link_override(s, d)
            self.fabric.set_link(s, d, model)
        self._active[ev.label] = ev  # lint: allow[unguarded-attr] documented contract ("Under self._lock"): the only caller, _apply, holds self._lock around this call
        return len(pairs)

    def _heal(self, label: Optional[str]) -> int:
        with self._lock:
            self._active.pop(label, None)
            saved = self._saved.pop(label, None)
            n = 0
            if saved:
                for (s, d), prev in saved.items():
                    if prev is None:
                        self.fabric.clear_link(s, d)
                    else:
                        self.fabric.set_link(s, d, prev)
                    n += 1
            return n

    def _on_register(self, addr: str) -> None:
        """Fabric registration hook: extend active faults to new endpoints so
        a node can't escape its partition by registering a fresh address."""
        with self._lock:
            for label, ev in self._active.items():
                eps = self.fabric.endpoints()
                pairs = [p for p in _event_pairs(ev, eps) if addr in p]
                if not pairs:
                    continue
                saved = self._saved.setdefault(label, {})
                model = ev.link if ev.kind == "degrade" else BLACKHOLE
                for s, d in pairs:
                    if (s, d) not in saved:
                        saved[(s, d)] = self.fabric.link_override(s, d)
                    self.fabric.set_link(s, d, model)

    def _record(self, ev: ChaosEvent, t: Optional[float], **extra) -> None:
        with self._lock:
            self.applied += 1
            entry = {"t_s": None if t is None else round(t, 6),
                     "kind": ev.kind, "label": ev.label}
            entry.update(extra)
            self.log.append(entry)
        if TRACER.enabled:
            # outside self._lock: fault apply/heal instants land in the SAME
            # timeline as the controller/2PC spans they perturb
            TRACER.event(f"chaos.{ev.kind}", attrs=dict(entry))


def _event_pairs(ev: ChaosEvent,
                 eps: Sequence[str]) -> List[Tuple[str, str]]:
    """Directed (src, dst) pairs an event overrides, given current endpoints."""
    if ev.kind == "crash":
        ours = [e for e in eps if node_matches(e, ev.a)]
        others = [e for e in eps if not node_matches(e, ev.a)]
        pairs = [(x, y) for x in ours for y in others]
    else:
        pa = [e for e in eps if node_matches(e, ev.a)]
        pb = [e for e in eps if node_matches(e, ev.b)]
        pairs = [(x, y) for x in pa for y in pb if x != y]
    if ev.symmetric:
        pairs = pairs + [(d, s) for s, d in pairs]
    seen, out = set(), []
    for p in pairs:
        if p not in seen:
            seen.add(p)
            out.append(p)
    return out


class VirtualClock:
    """Deterministic stand-in for ``time.monotonic`` in schedule tests:
    ``poll(now=clock())`` after ``clock.advance(dt)`` replays a plan exactly,
    independent of CI machine speed."""

    def __init__(self, t: float = 0.0):
        self._t = t
        self._lock = threading.Lock()

    def __call__(self) -> float:
        with self._lock:
            return self._t

    def advance(self, dt: float) -> float:
        with self._lock:
            self._t += dt
            return self._t
