"""Flight recorder: bounded recent-history dump on failure.

The tracer's per-thread rings (``deque(maxlen=capacity)``) *are* the
bounded history — the flight recorder is the dump trigger. Two triggers
(docs/architecture.md §10):

* :meth:`FlightRecorder.capture` — context manager wrapped around chaos
  scenario assertion blocks; an ``AssertionError`` inside dumps
  ``benchmarks/out/flightrec_<reason>.json`` and re-raises.
* :func:`strand_alarm` — called by ``HostAgent._resync_prepared`` when a
  2PC participant's resync keeps failing (a peer is prepared but cannot
  learn the verdict — the stranded-peer condition); dumps once per conn.

Dumps only happen while tracing is enabled: the recorder is an
observability feature, not an always-on side effect of running tests.
Stdlib-only.
"""
from __future__ import annotations

import glob
import json
import os
import threading
from typing import Optional, Set

from repro_torch.obs.trace import TRACER, Tracer

__all__ = ["FlightRecorder", "RECORDER", "strand_alarm"]

_DEFAULT_OUT = os.path.join("benchmarks", "out")
_DEFAULT_KEEP = 16


class FlightRecorder:
    """Dumps the tracer's recent spans/events to a JSON file on demand.

    ``max_dumps`` (env ``REPRO_FLIGHTREC_KEEP``) caps how many
    ``flightrec_*.json`` files the out dir retains: after each write the
    oldest dumps beyond the cap are deleted, so repeated chaos runs cannot
    grow the directory unboundedly. 0 disables rotation.
    """

    def __init__(self, tracer: Optional[Tracer] = None,
                 out_dir: Optional[str] = None,
                 max_dumps: Optional[int] = None):
        self.tracer = tracer or TRACER
        self.out_dir = out_dir or os.environ.get("REPRO_FLIGHTREC_DIR",
                                                 _DEFAULT_OUT)
        if max_dumps is None:
            max_dumps = int(os.environ.get("REPRO_FLIGHTREC_KEEP",
                                           _DEFAULT_KEEP))
        self.max_dumps = max_dumps
        self._lock = threading.Lock()
        self._dumped: Set[str] = set()
        self.dumps = 0

    def dump(self, reason: str, extra: Optional[dict] = None,
             once: bool = False) -> Optional[str]:
        """Write ``flightrec_<reason>.json``; returns the path or None.

        ``once=True`` dedupes by reason (the strand alarm fires per retry
        tick; one dump per stranded conn is enough). No-op when tracing
        is disabled — there is nothing in the rings worth writing.
        """
        if not self.tracer.enabled:
            return None
        with self._lock:
            if once and reason in self._dumped:
                return None
            self._dumped.add(reason)
            self.dumps += 1
        safe = "".join(c if c.isalnum() or c in "-_." else "_"
                       for c in reason)
        os.makedirs(self.out_dir, exist_ok=True)
        path = os.path.join(self.out_dir, f"flightrec_{safe}.json")
        payload = {
            "reason": reason,
            "extra": extra or {},
            "records": self.tracer.collect(),
        }
        with open(path, "w") as f:
            json.dump(payload, f, indent=1, default=str)
        self._rotate(keep=path)
        return path

    def _rotate(self, keep: str) -> None:
        """Delete the oldest ``flightrec_*.json`` beyond ``max_dumps``.

        Ordered oldest-first by (mtime, name); the file just written is
        always retained even if a coarse filesystem clock ties every mtime.
        """
        if self.max_dumps <= 0:
            return
        dumps = glob.glob(os.path.join(self.out_dir, "flightrec_*.json"))
        if len(dumps) <= self.max_dumps:
            return
        keep_abs = os.path.abspath(keep)
        dumps.sort(key=lambda p: (os.path.getmtime(p), p))
        excess = len(dumps) - self.max_dumps
        for p in dumps:
            if excess <= 0:
                break
            if os.path.abspath(p) == keep_abs:
                continue
            try:
                os.remove(p)
                excess -= 1
            except OSError:  # pragma: no cover - raced with another writer
                pass

    def capture(self, reason: str):
        """``with RECORDER.capture("chaos_smoke"): assert ...`` — dump on
        AssertionError, then re-raise."""
        return _Capture(self, reason)


class _Capture:
    __slots__ = ("_rec", "_reason")

    def __init__(self, rec: FlightRecorder, reason: str):
        self._rec = rec
        self._reason = reason

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None and issubclass(exc_type, AssertionError):
            self._rec.dump(f"{self._reason}_assert",
                           extra={"assertion": str(exc)})
        return False


#: Process-global recorder bound to the global TRACER.
RECORDER = FlightRecorder()


def strand_alarm(conn_id: str, peer: str, failures: int) -> Optional[str]:
    """2PC stranded-peer trigger: record the event and dump once per conn."""
    TRACER.event("2pc.strand_alarm",
                 attrs={"conn_id": conn_id, "peer": peer,
                        "failures": failures, "drop_reason": "resync_stalled"})
    return RECORDER.dump(f"strand_{conn_id}",
                         extra={"conn_id": conn_id, "peer": peer,
                                "failures": failures}, once=True)
