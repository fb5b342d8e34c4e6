"""SLO engine: declarative objectives, error budgets, burn-rate alarms.

The controller plane (``ReconfigController`` + policies) reasons over flat
signal dicts. Raw thresholds ("p95 > 5ms") are brittle: they fire on one
noisy sample and say nothing about how much unreliability the service can
still afford. This module turns objectives into *budget* arithmetic, the SRE
formulation:

  * an ``SLO`` declares an objective over ONE metric of the federated view
    (``repro_torch.obs.federate``) — a latency quantile bound, an error ratio, or
    an availability floor. The error budget is ``1 - objective``: the
    fraction of time (or requests) allowed to be bad per budget window.
  * the ``SLOEngine`` samples the view, classifies each instant as good/bad,
    and maintains a rolling, time-weighted bad-fraction over TWO windows —
    fast (default 5s) and slow (default 60s). ``burn rate`` is the windowed
    bad-fraction divided by the budget: burn 1.0 spends exactly the budget
    over the budget window; burn 14.4 exhausts a 30-day budget in 2 days.
  * an alarm (breach) requires BOTH windows above their burn thresholds —
    the fast window gives low detection latency, the slow window keeps a
    transient spike from paging — and resolves when the fast window falls
    back under its threshold (the standard multi-window reset).

Breach/recovery are first-class events: they appear in ``events``, emit
``TRACER`` instants, trip the flight recorder (post-hoc ring dump, §10), and
are exported as ``slo.*`` keys so any policy predicate — and the
``slo_guard`` built-in — can arm a stack switch on budget burn instead of a
raw threshold.

Windowing note for short runs: window means divide by
``min(window, elapsed)`` — the fraction is over *observed* time, so a
benchmark that has only run 3s still produces a meaningful fast-window burn,
while a long-running service gets true multi-window dilution.

Lock discipline (enforced by ``repro_torch.lint``'s blocking-under-lock rule):
``observe`` computes under ``_lock`` but fires tracer events and flight-
recorder dumps only AFTER releasing it — the recorder does file I/O and the
KV-backed view callables must never be invoked under the engine's lock.

Stdlib-only (plus sibling ``obs`` modules): importable from ``repro_torch.obs``
without dragging in the fleet or core planes.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import (Any, Callable, Deque, Dict, List, Mapping, Optional,
                    Sequence, Tuple)

from repro_torch.obs.flight import RECORDER, FlightRecorder
from repro_torch.obs.trace import TRACER

__all__ = ["SLO", "SLOEngine", "latency_slo_for", "error_ratio_slo_for",
           "availability_slo_for"]

_KINDS = ("latency", "error_ratio", "availability")


@dataclass(frozen=True)
class SLO:
    """One declarative objective over one metric of a signal view.

    Args:
        name: signal namespace — the engine exports ``slo.<name>.*`` keys.
        metric: the view key to judge (e.g. ``obs.conn.rtt_p95_s`` or
            ``obs.region.edge.conn.rtt_p95_s`` from the federated view).
        objective: target good-fraction in [0, 1); the error budget is
            ``1 - objective``.
        threshold: for ``kind="latency"``: the bound the metric must stay
            under — an instant is bad iff ``value > threshold``.
        kind: ``latency`` (binary bad on threshold crossing),
            ``error_ratio`` (the metric IS the bad fraction, clamped to
            [0, 1]), or ``availability`` (bad = 1 - clamped metric).
    """

    name: str
    metric: str
    objective: float = 0.99
    threshold: Optional[float] = None
    kind: str = "latency"

    def __post_init__(self) -> None:
        if self.kind not in _KINDS:
            raise ValueError(f"unknown SLO kind {self.kind!r}; "
                             f"expected one of {_KINDS}")
        if not 0.0 <= self.objective < 1.0:
            raise ValueError(f"objective must be in [0, 1), "
                             f"got {self.objective}")
        if self.kind == "latency" and self.threshold is None:
            raise ValueError("latency SLOs need a threshold")

    @property
    def budget(self) -> float:
        """Allowed bad-fraction per budget window (never zero — a 100%%
        objective would make every burn rate infinite)."""
        return max(1e-9, 1.0 - self.objective)

    def bad_fraction(self, view: Mapping[str, Any]) -> Optional[float]:
        """Classify one view sample: 0.0 good .. 1.0 bad; None = no data."""
        v = view.get(self.metric)
        if v is None:
            return None
        try:
            v = float(v)
        except (TypeError, ValueError):
            return None
        if v != v:  # NaN: the metric exists but carries no information
            return None
        if self.kind == "latency":
            return 1.0 if v > float(self.threshold) else 0.0
        clamped = min(1.0, max(0.0, v))
        return clamped if self.kind == "error_ratio" else 1.0 - clamped


def latency_slo_for(metric: str, threshold: float, *, name: str = "latency",
                    objective: float = 0.99) -> SLO:
    return SLO(name=name, metric=metric, objective=objective,
               threshold=threshold, kind="latency")


def error_ratio_slo_for(metric: str, *, name: str = "errors",
                        objective: float = 0.999) -> SLO:
    return SLO(name=name, metric=metric, objective=objective,
               kind="error_ratio")


def availability_slo_for(metric: str, *, name: str = "availability",
                         objective: float = 0.99) -> SLO:
    return SLO(name=name, metric=metric, objective=objective,
               kind="availability")


@dataclass
class _Track:
    """Per-SLO rolling state: (t, bad) samples + budget integral."""

    samples: Deque[Tuple[float, float]] = field(default_factory=deque)
    first_t: Optional[float] = None
    last_t: Optional[float] = None
    last_bad: float = 0.0
    bad_seconds: float = 0.0     # integral of bad over the whole run
    alarm: bool = False
    breaches: int = 0
    recoveries: int = 0

    def window_mean(self, now: float, window: float) -> float:
        """Time-weighted mean of bad over [now - window, now].

        Each sample's value holds until the next sample (step function); the
        denominator is clipped to observed time so short runs still produce
        a defined fraction instead of dividing a 3s history by 60s.
        """
        if self.first_t is None:
            return 0.0
        lo = now - window
        span = min(window, max(0.0, now - self.first_t))
        if span <= 0.0:
            return self.last_bad
        total = 0.0
        pts = list(self.samples)
        for i, (t, bad) in enumerate(pts):
            t_end = pts[i + 1][0] if i + 1 < len(pts) else now
            a, b = max(t, lo), min(t_end, now)
            if b > a:
                total += bad * (b - a)
        return total / span


class SLOEngine:
    """Evaluate SLOs over a signal view; export ``slo.*`` burn-rate signals.

    Args:
        slos: the objectives to track.
        fast_window_s / slow_window_s: multi-window burn evaluation spans.
        budget_window_s: the period one full error budget covers (burn 1.0
            spends it exactly; ``budget_spent`` is the run's cumulative
            bad-time over ``budget * budget_window_s``).
        fast_burn / slow_burn: alarm thresholds per window. The defaults
            (14.4 / 6.0) are the classic page-worthy burn rates for a 30-day
            budget (2%% of budget in 1h / 5%% in 6h), kept as plain numbers
            here — what matters is fast >> slow >> 1.
        view_fn: optional view supplier; with it the engine is a
            self-contained ``SignalSource`` (``read()`` samples the view),
            without it callers push views via ``observe``.
        recorder: flight recorder tripped (``once`` per SLO) on breach.
        now: clock override for deterministic tests.
    """

    name = "slo"

    def __init__(self, slos: Sequence[SLO], *, fast_window_s: float = 5.0,
                 slow_window_s: float = 60.0,
                 budget_window_s: float = 3600.0,
                 fast_burn: float = 14.4, slow_burn: float = 6.0,
                 view_fn: Optional[Callable[[], Mapping[str, Any]]] = None,
                 recorder: Optional[FlightRecorder] = RECORDER,
                 now: Callable[[], float] = time.monotonic):
        if not slos:
            raise ValueError("SLOEngine needs at least one SLO")
        names = [s.name for s in slos]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate SLO names: {names}")
        self.slos: Tuple[SLO, ...] = tuple(slos)
        self.fast_window_s = fast_window_s
        self.slow_window_s = slow_window_s
        self.budget_window_s = budget_window_s
        self.fast_burn = fast_burn
        self.slow_burn = slow_burn
        self.view_fn = view_fn
        self.recorder = recorder
        self._now = now
        self._lock = threading.Lock()
        self._tracks: Dict[str, _Track] = {s.name: _Track() for s in slos}
        self._signals: Dict[str, Any] = {"slo.alarms": 0}
        self.events: List[dict] = []

    # -- sampling --------------------------------------------------------------
    def observe(self, view: Mapping[str, Any],
                now: Optional[float] = None) -> Dict[str, Any]:
        """Fold one view sample into every SLO's windows; return the
        ``slo.*`` signal dict. Missing/NaN metrics leave that SLO's state
        untouched (no data is not good data)."""
        now = self._now() if now is None else now
        fired: List[dict] = []       # (tracer/recorder work, done unlocked)
        with self._lock:
            horizon = max(self.slow_window_s, self.fast_window_s) * 2.0
            alarms = 0
            for slo in self.slos:
                tr = self._tracks[slo.name]
                bad = slo.bad_fraction(view)
                if bad is not None:
                    if tr.last_t is not None and now > tr.last_t:
                        # the previous sample's value held until now
                        tr.bad_seconds += tr.last_bad * (now - tr.last_t)
                    if tr.first_t is None:
                        tr.first_t = now
                    tr.samples.append((now, bad))
                    tr.last_t, tr.last_bad = now, bad
                    while (len(tr.samples) > 1
                           and tr.samples[1][0] <= now - horizon):
                        tr.samples.popleft()
                burn_fast = (tr.window_mean(now, self.fast_window_s)
                             / slo.budget)
                burn_slow = (tr.window_mean(now, self.slow_window_s)
                             / slo.budget)
                spent = tr.bad_seconds / (slo.budget * self.budget_window_s)
                if (not tr.alarm and burn_fast > self.fast_burn
                        and burn_slow > self.slow_burn):
                    tr.alarm = True
                    tr.breaches += 1
                    fired.append({"slo": slo.name, "kind": "breach", "t": now,
                                  "burn_fast": burn_fast,
                                  "burn_slow": burn_slow,
                                  "budget_spent": spent})
                elif tr.alarm and burn_fast < self.fast_burn:
                    tr.alarm = False
                    tr.recoveries += 1
                    fired.append({"slo": slo.name, "kind": "recovery",
                                  "t": now, "burn_fast": burn_fast,
                                  "burn_slow": burn_slow,
                                  "budget_spent": spent})
                alarms += tr.alarm
                p = f"slo.{slo.name}."
                self._signals[p + "bad"] = tr.last_bad
                self._signals[p + "burn_fast"] = burn_fast
                self._signals[p + "burn_slow"] = burn_slow
                self._signals[p + "alarm"] = 1.0 if tr.alarm else 0.0
                self._signals[p + "ok"] = 0.0 if tr.alarm else 1.0
                self._signals[p + "budget_spent"] = spent
                self._signals[p + "budget_remaining"] = max(0.0, 1.0 - spent)
                self._signals[p + "breaches"] = tr.breaches
            self._signals["slo.alarms"] = alarms
            self.events.extend(fired)
            out = dict(self._signals)
        # breach/recovery side effects OUTSIDE the lock: the tracer ring is
        # its own sync domain and the recorder does file I/O
        for ev in fired:
            TRACER.event(f"slo.{ev['kind']}", {k: v for k, v in ev.items()
                                               if k != "kind"})
            if ev["kind"] == "breach" and self.recorder is not None:
                self.recorder.dump(f"slo_breach_{ev['slo']}",
                                   extra=ev, once=True)
        return out

    # -- SignalSource protocol -------------------------------------------------
    def read(self, now: Optional[float] = None) -> Dict[str, Any]:
        """Latest ``slo.*`` signals; with a ``view_fn`` this re-samples the
        view first, making the engine a drop-in ``SignalSource`` for
        ``FleetAggregator.add_source`` / controller signal merges."""
        if self.view_fn is not None:
            return self.observe(self.view_fn(), now)
        with self._lock:
            return dict(self._signals)

    def signals(self) -> Dict[str, Any]:
        """Latest ``slo.*`` dict without re-sampling (peek)."""
        with self._lock:
            return dict(self._signals)

    def alarmed(self) -> List[str]:
        with self._lock:
            return [s.name for s in self.slos if self._tracks[s.name].alarm]

    # -- reporting -------------------------------------------------------------
    def report(self, now: Optional[float] = None) -> List[Dict[str, Any]]:
        """One row per SLO for dashboards/CLI: objective, budget, burns,
        alarm state, breach counts."""
        now = self._now() if now is None else now
        rows: List[Dict[str, Any]] = []
        with self._lock:
            for slo in self.slos:
                tr = self._tracks[slo.name]
                spent = tr.bad_seconds / (slo.budget * self.budget_window_s)
                rows.append({
                    "slo": slo.name, "kind": slo.kind, "metric": slo.metric,
                    "objective": slo.objective, "threshold": slo.threshold,
                    "budget": slo.budget,
                    "burn_fast": tr.window_mean(now, self.fast_window_s)
                    / slo.budget,
                    "burn_slow": tr.window_mean(now, self.slow_window_s)
                    / slo.budget,
                    "budget_spent": spent,
                    "budget_remaining": max(0.0, 1.0 - spent),
                    "alarm": tr.alarm, "breaches": tr.breaches,
                    "recoveries": tr.recoveries,
                    "samples": len(tr.samples),
                })
        return rows
