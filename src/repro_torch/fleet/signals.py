"""External signal sources merged into fleet snapshots.

A ``SignalSource`` contributes namespaced keys (``ext.*``) to the snapshot
dict a ``FleetAggregator`` produces, so registered policies can write
predicates that COMBINE fleet aggregates with out-of-band signals — carbon
intensity, spot price, measured link bandwidth — without the controller core
knowing any of them exist (ROADMAP "Multi-source predicates"; cf. Morpheus:
the payoff of runtime specialization comes from a continuous shared view of
runtime signals feeding the decision).

Sources are read once per aggregation tick and must be cheap; anything slow
(a real HTTP carbon API, a bandwidth probe) caches internally and refreshes
on its own cadence (see ``LinkBandwidthSignal.refresh_s``).
"""
from __future__ import annotations

import logging
import time
from typing import Callable, Dict, Optional, Sequence

from repro_torch.core.fabric import Fabric

log = logging.getLogger(__name__)


class SignalError(RuntimeError):
    """A signal source could not produce a value this tick.

    Typed so the aggregator (and tests) can tell an expected source outage
    from a programming error; carries the probe failure as ``__cause__`` when
    one triggered it."""


class SignalSource:
    """One external signal: ``read(now)`` returns namespaced snapshot keys.

    Implementations OWN their key namespace (conventionally ``ext.<what>``) —
    the aggregator merges the dicts verbatim, so two sources emitting the same
    key is a configuration error, not something the plane resolves."""

    #: human-readable source name (diagnostics; keys carry the namespace)
    name = "signal"

    def read(self, now: Optional[float] = None) -> Dict[str, float]:
        raise NotImplementedError


class StaticSignal(SignalSource):
    """Fixed values — config-pinned signals and deterministic tests."""

    def __init__(self, values: Dict[str, float], name: str = "static"):
        self.values = dict(values)
        self.name = name

    def read(self, now: Optional[float] = None) -> Dict[str, float]:
        return dict(self.values)


class CallbackSignal(SignalSource):
    """Adapter for an arbitrary ``fn(now) -> {key: value}``."""

    def __init__(self, fn: Callable[[Optional[float]], Dict[str, float]],
                 name: str = "callback"):
        self.fn = fn
        self.name = name

    def read(self, now: Optional[float] = None) -> Dict[str, float]:
        return dict(self.fn(now) or {})


class _TraceSignal(SignalSource):
    """Base for signals that replay a periodic trace against the clock —
    the offline stand-in for a live feed (grid carbon API, cloud spot market).
    ``trace[i]`` holds for ``period_s``; the trace wraps."""

    key = "ext.value"

    def __init__(self, trace: Sequence[float], *, period_s: float = 60.0,
                 now: Callable[[], float] = time.monotonic):
        if not trace:
            raise ValueError(f"{type(self).__name__} needs a non-empty trace")
        self.trace = list(trace)
        self.period_s = period_s
        self._now = now
        self._t0 = now()

    def value(self, now: Optional[float] = None) -> float:
        now = self._now() if now is None else now
        idx = int(max(now - self._t0, 0.0) / self.period_s)
        return float(self.trace[idx % len(self.trace)])

    def read(self, now: Optional[float] = None) -> Dict[str, float]:
        return {self.key: self.value(now)}


class CarbonIntensitySignal(_TraceSignal):
    """Grid carbon intensity, gCO2/kWh — ``ext.carbon_gco2``."""

    name = "carbon"
    key = "ext.carbon_gco2"


class SpotPriceSignal(_TraceSignal):
    """Spot instance price, $/h — ``ext.spot_usd_per_h``."""

    name = "spot"
    key = "ext.spot_usd_per_h"


# ---------------------------------------------------------------------------
# Measured link bandwidth (mesh-aware cost models, ROADMAP)
# ---------------------------------------------------------------------------


def measure_link_bandwidth(fabric: Optional[Fabric] = None, *,
                           payload_bytes: int = 1 << 16,
                           n_msgs: int = 32,
                           timeout_s: float = 1.0) -> float:
    """Measured bytes/s of one fabric link, from a ``bench_collectives``-style
    micro-run: time ``n_msgs`` payloads of ``payload_bytes`` through a fresh
    endpoint pair. On a fabric with a ``LinkModel`` this observes the modeled
    latency; on the default zero-latency fabric it measures the in-process
    copy floor — either way the value orders byte-heavy options honestly,
    which is all the cost scorer needs."""
    fabric = fabric or Fabric()
    tag = time.monotonic_ns()
    src = fabric.register(f"bwprobe-src-{tag}")
    dst = fabric.register(f"bwprobe-dst-{tag}")
    payload = b"\x00" * payload_bytes
    try:
        t0 = time.perf_counter()
        got = 0
        for _ in range(n_msgs):
            src.send(dst.addr, payload)
            if dst.recv(timeout=timeout_s) is not None:
                got += 1
        dt = max(time.perf_counter() - t0, 1e-9)
    finally:
        src.close()
        dst.close()
    if got == 0:
        raise TimeoutError("bandwidth probe received nothing")
    return got * payload_bytes / dt


class LinkBandwidthSignal(SignalSource):
    """Measured slow-tier bandwidth — ``ext.link_bytes_per_s`` plus its
    reciprocal ``ext.dcn_s_per_byte`` (the ``Objective`` normalizer, see
    ``repro_torch.comm.chunnels.calibrated_objective``).

    The probe is a micro-run (``measure_link_bandwidth`` by default, or any
    ``probe() -> bytes/s`` — e.g. one derived from ``bench_collectives``
    output); it runs at most once per ``refresh_s`` and the cached value is
    served in between, so reading this source per aggregation tick stays
    cheap."""

    name = "link_bw"

    def __init__(self, probe: Optional[Callable[[], float]] = None, *,
                 fabric: Optional[Fabric] = None,
                 refresh_s: float = 30.0,
                 now: Callable[[], float] = time.monotonic):
        self.probe = probe or (lambda: measure_link_bandwidth(fabric))
        self.refresh_s = refresh_s
        self._now = now
        self._measured_at: Optional[float] = None
        self._bytes_per_s: Optional[float] = None
        self.probes = 0

    def read(self, now: Optional[float] = None) -> Dict[str, float]:
        now = self._now() if now is None else now
        if (self._measured_at is None
                or now - self._measured_at >= self.refresh_s):
            # stamp success AND failure: a failing probe is retried after
            # refresh_s, never on every aggregation tick (it can block for
            # seconds). With a cached measurement we keep serving it; without
            # one the failure is the aggregator's to count (signal_errors).
            self._measured_at = now
            try:
                self._bytes_per_s = float(self.probe())
                self.probes += 1
            except Exception as e:
                # a failed probe is logged at DEBUG, never swallowed silently.
                # With a cached measurement we keep serving it; without one
                # the typed error below tells the aggregator why.
                log.debug("link bandwidth probe failed: %s", e)
                if self._bytes_per_s is None:
                    raise SignalError(
                        f"bandwidth probe failed with no cached value: {e}"
                    ) from e
        bw = self._bytes_per_s
        if not bw:
            # no usable measurement yet (first probe failed, or measured 0):
            # refuse cheaply until the next refresh window instead of
            # emitting None/inf values into the snapshot
            raise SignalError("bandwidth probe has not succeeded yet")
        return {"ext.link_bytes_per_s": bw,
                "ext.dcn_s_per_byte": 1.0 / bw}
