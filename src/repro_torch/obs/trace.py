"""Low-overhead causal tracing for the reconfiguration lifecycle.

Design constraints (docs/architecture.md §10):

* **Off-by-default cheap.** Every instrumentation site in the hot path is
  guarded by a single ``if TRACER.enabled:`` attribute read (the torch
  sites of ``obs/ranges.py`` also ask torch whether a profiler records);
  the disabled path allocates nothing and builds no autograd node, held to
  that by ``tests/test_torch_trace_ranges.py``. Enabled tracing must stay
  <10% at batch=64, which is why the data plane records compact tuples
  (:meth:`Tracer.record_batch`) instead of full spans.
* **Lock-free rings.** Finished records land in a per-thread
  ``deque(maxlen=...)`` reached through ``threading.local`` — appends are
  single bytecodes under the GIL, so recording never takes a lock and can
  run inside fabric/chaos critical sections without inverting lock order.
  The only lock (``_reg_lock``) guards the ring *registry* and is taken
  once per thread lifetime plus on control-plane toggles.
* **Two record tiers.** Control-plane phases (negotiation, 2PC, swaps,
  controller ticks) are full :class:`Span` objects with parentage,
  attributes, and nested events. Data-plane batches are 5-tuples
  ``(name, t, n, n_ok, extra)`` — one per *batch*, never per message
  (machine-enforced by the ``span-in-hot-loop`` lint rule).
* **Wire propagation.** ``ctx()`` returns a compact ``(trace_id,
  span_id)`` pair that rides ``ReliableChannel`` frames (``"_tc"``) and
  ``comm/wire.py`` chunk headers (``hdr["tc"]``); the receiving side
  re-parents via :meth:`Tracer.adopt`, so one trace stitches across
  endpoints and threads.

Everything here is stdlib-only so any core module may import ``TRACER``
without cycles. ``obs/ranges.py`` puts the port's torch code on the
profiler's clock: its sites are spans of ``TRACER`` and, while a torch
profiler records, profiler ranges.
"""
from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from typing import Dict, Iterable, List, Optional, Tuple

__all__ = ["Span", "Tracer", "TRACER", "NOOP_SPAN"]

TraceCtx = Tuple[int, int]  # (trace_id, span_id) — the over-the-wire form

_DEFAULT_CAPACITY = 8192  # per-thread ring depth (the flight-recorder bound)

_perf = time.perf_counter  # module-global: skip the attribute walk on hot paths


class _NoopSpan:
    """Absorbs the full Span surface so call sites never branch twice.

    Falsy, so ``sp = TRACER.begin_span(...)`` followed by ``if sp:`` also
    works for manual (non-``with``) spans.
    """

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __bool__(self):
        return False

    def set(self, **attrs):
        return self

    def event(self, name, **attrs):
        return self

    def end(self, status=None, **attrs):
        return self


NOOP_SPAN = _NoopSpan()


class Span:
    """One timed phase. Context manager or manual ``begin_span``/``end``.

    ``events`` holds ``(t, name, attrs)`` instants that stay attached to
    the span (e.g. per-peer 2PC votes, retransmits tagged ``retry=n``).
    """

    __slots__ = ("trace_id", "span_id", "parent_id", "name", "t0", "t1",
                 "attrs", "events", "status", "thread", "_tracer")

    def __init__(self, tracer: "Tracer", name: str, trace_id: int,
                 span_id: int, parent_id: Optional[int],
                 attrs: Optional[dict] = None):
        self._tracer = tracer
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.t0 = time.perf_counter()
        self.t1: Optional[float] = None
        self.attrs = dict(attrs) if attrs else {}
        self.events: List[Tuple[float, str, dict]] = []
        self.status = "ok"
        self.thread = threading.current_thread().name

    # -- wire form ---------------------------------------------------------
    @property
    def ctx(self) -> TraceCtx:
        return (self.trace_id, self.span_id)

    # -- mutation ----------------------------------------------------------
    def set(self, **attrs) -> "Span":
        status = attrs.pop("status", None)
        if status is not None:  # mirrors end(status=...): a pre-raise
            self.status = status  # classification survives __exit__
        self.attrs.update(attrs)
        return self

    def event(self, name: str, **attrs) -> "Span":
        self.events.append((time.perf_counter(), name, attrs))
        return self

    def end(self, status: Optional[str] = None, **attrs) -> "Span":
        if self.t1 is not None:  # idempotent: double-end keeps first timing
            return self
        self.t1 = time.perf_counter()
        if status is not None:
            self.status = status
        if attrs:
            self.attrs.update(attrs)
        self._tracer._finish(self)
        return self

    # -- context-manager protocol -----------------------------------------
    def __enter__(self) -> "Span":
        self._tracer._push(self)
        return self

    def __exit__(self, exc_type, exc, tb):
        self._tracer._pop(self)
        if exc_type is not None and self.status == "ok":
            self.status = "error"
            self.attrs.setdefault("error", f"{exc_type.__name__}: {exc}")
        self.end()
        return False

    def to_dict(self) -> dict:
        return {
            "kind": "span",
            "name": self.name,
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "ts": self.t0,
            "dur": (self.t1 - self.t0) if self.t1 is not None else None,
            "status": self.status,
            "thread": self.thread,
            "attrs": self.attrs,
            "events": [{"ts": t, "name": n, "attrs": a}
                       for (t, n, a) in self.events],
        }


class _RemoteParent:
    """Stack sentinel for a parent span living on another endpoint."""

    __slots__ = ("trace_id", "span_id")

    def __init__(self, tc: TraceCtx):
        self.trace_id, self.span_id = tc


class _Adopt:
    """Context manager pushing a remote trace ctx as the current parent."""

    __slots__ = ("_tracer", "_sentinel")

    def __init__(self, tracer: "Tracer", tc: Optional[TraceCtx]):
        self._tracer = tracer
        self._sentinel = _RemoteParent(tc) if tc is not None else None

    def __enter__(self):
        if self._sentinel is not None:
            self._tracer._push(self._sentinel)
        return self._sentinel

    def __exit__(self, *exc):
        if self._sentinel is not None:
            self._tracer._pop(self._sentinel)
        return False


class Tracer:
    """Process-global span/record collector. See module docstring.

    The singleton :data:`TRACER` starts disabled; ``enable()`` is the
    explicit opt-in (CLI scenario, chaos smoke, tests). All recording
    methods are safe to call from any thread at any time.
    """

    def __init__(self, capacity: int = _DEFAULT_CAPACITY):
        self.enabled = False
        self.capacity = capacity
        self._ids = itertools.count(1)  # C-level next(): no lock needed
        self._tls = threading.local()
        self._reg_lock = threading.Lock()
        # thread-id -> (thread-name, ring). Rings outlive their threads so
        # collect() still sees records from finished agent loops.
        self._rings: Dict[int, Tuple[str, deque]] = {}

    # -- control plane -----------------------------------------------------
    def enable(self, capacity: Optional[int] = None) -> None:
        with self._reg_lock:
            if capacity is not None:
                self.capacity = capacity
            self.enabled = True

    def disable(self) -> None:
        with self._reg_lock:
            self.enabled = False

    def reset(self) -> None:
        """Drop all recorded data (rings stay registered)."""
        with self._reg_lock:
            for _name, ring in self._rings.values():
                ring.clear()

    # -- ring / stack plumbing --------------------------------------------
    def _ring(self) -> deque:
        try:
            return self._tls.ring
        except AttributeError:
            ring = deque(maxlen=self.capacity)
            th = threading.current_thread()
            with self._reg_lock:
                self._rings[th.ident] = (th.name, ring)
            self._tls.ring = ring
            return ring

    def _stack(self) -> list:
        try:
            return self._tls.stack
        except AttributeError:
            stack = []
            self._tls.stack = stack
            return stack

    def _push(self, span) -> None:
        self._stack().append(span)

    def _pop(self, span) -> None:
        stack = self._stack()
        if stack and stack[-1] is span:
            stack.pop()
        elif span in stack:  # tolerate out-of-order exits
            stack.remove(span)

    def _finish(self, span: Span) -> None:
        self._ring().append(span)

    def _parent(self, ctx: Optional[TraceCtx]):
        """Resolve (trace_id, parent_span_id) for a new span/event."""
        if ctx is not None:
            return ctx[0], ctx[1]
        stack = self._stack()
        if stack:
            top = stack[-1]
            return top.trace_id, top.span_id
        return next(self._ids), None

    # -- recording API -----------------------------------------------------
    def span(self, name: str, attrs: Optional[dict] = None,
             ctx: Optional[TraceCtx] = None):
        """New span for ``with`` use; NOOP_SPAN when disabled.

        Call sites on warm paths should still guard with
        ``if TRACER.enabled:`` so the ``attrs`` dict is never built.
        """
        if not self.enabled:
            return NOOP_SPAN
        trace_id, parent_id = self._parent(ctx)
        return Span(self, name, trace_id, next(self._ids), parent_id, attrs)

    def begin_span(self, name: str, attrs: Optional[dict] = None,
                   ctx: Optional[TraceCtx] = None):
        """Manual span: caller owns ``end()``; not pushed on the stack.

        Used where the span outlives a lexical scope (e.g. a
        ``ReliableChannel`` window that retries across loop iterations and
        must keep ONE span id on every retransmitted frame).
        """
        if not self.enabled:
            return NOOP_SPAN
        trace_id, parent_id = self._parent(ctx)
        return Span(self, name, trace_id, next(self._ids), parent_id, attrs)

    def adopt(self, tc: Optional[TraceCtx]) -> _Adopt:
        """Parent subsequent spans under a ctx received over the wire."""
        return _Adopt(self, tc if self.enabled else None)

    def ctx(self) -> Optional[TraceCtx]:
        """Compact (trace_id, span_id) of the current span, for the wire."""
        if not self.enabled:
            return None
        stack = self._stack()
        if not stack:
            return None
        top = stack[-1]
        return (top.trace_id, top.span_id)

    def event(self, name: str, attrs: Optional[dict] = None,
              ctx: Optional[TraceCtx] = None) -> None:
        """Zero-duration instant (chaos faults, drops, reassembly...)."""
        if not self.enabled:
            return
        trace_id, parent_id = self._parent(ctx)
        self._ring().append({
            "kind": "event",
            "name": name,
            "trace_id": trace_id,
            "span_id": next(self._ids),
            "parent_id": parent_id,
            "ts": time.perf_counter(),
            "dur": 0.0,
            "status": "ok",
            "thread": threading.current_thread().name,
            "attrs": dict(attrs) if attrs else {},
            "events": [],
        })

    def record_batch(self, name: str, n: int, n_ok: int,
                     extra: Optional[dict] = None) -> None:
        """Fast-path batch record: one tuple append, no Span object.

        The ONLY sanctioned per-batch instrumentation for ``Datapath`` /
        fabric hot loops. Callers must pre-guard with ``TRACER.enabled``.
        The TLS ring access is inlined (no ``_ring()`` call) — this method
        sits inside the <10%-overhead budget ``bench_overhead`` gates.
        """
        try:
            ring = self._tls.ring
        except AttributeError:
            ring = self._ring()
        ring.append((name, _perf(), n, n_ok, extra))

    # -- export ------------------------------------------------------------
    def collect(self, clear: bool = False) -> List[dict]:
        """Snapshot every ring into normalized dicts, sorted by ``ts``.

        Open spans (begun, never ended) are not included — they are still
        owned by their call sites.
        """
        with self._reg_lock:
            rings = [(name, list(ring)) for name, ring in
                     self._rings.values()]
            if clear:
                for _name, ring in self._rings.values():
                    ring.clear()
        out: List[dict] = []
        for _name, entries in rings:
            for e in entries:
                if isinstance(e, Span):
                    out.append(e.to_dict())
                elif isinstance(e, dict):
                    out.append(e)
                else:  # fast-path tuple (name, t, n, n_ok, extra)
                    name, t, n, n_ok, extra = e
                    rec = {
                        "kind": "batch",
                        "name": name,
                        "trace_id": None,
                        "span_id": None,
                        "parent_id": None,
                        "ts": t,
                        "dur": 0.0,
                        "status": "ok" if n_ok == n else "partial",
                        "thread": _name,
                        "attrs": {"n": n, "n_ok": n_ok},
                        "events": [],
                    }
                    if extra:
                        rec["attrs"].update(extra)
                    out.append(rec)
        out.sort(key=lambda r: r["ts"])
        return out

    def spans(self, name: Optional[str] = None) -> List[dict]:
        """Convenience for tests: collected spans, optionally by name."""
        return [r for r in self.collect()
                if r["kind"] == "span" and (name is None or r["name"] == name)]


#: Process-global tracer. Starts disabled; ``TRACER.enable()`` opts in.
TRACER = Tracer()
