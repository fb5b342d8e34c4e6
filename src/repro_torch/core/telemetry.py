"""Connection & step telemetry: the observation half of Bertha's closed loop.

``ReconfigStats`` (reconfigure.py) records what a switch *cost*; this module
records the signals that tell a policy *when* to switch: bytes on the wire,
per-op latency (incremental EWMA quantile estimates), per-pod step times for
straggler detection, and snapshot-windowed rates. Every ``ConnHandle`` carries
a ``ConnTelemetry``; the trainer feeds one per job. ``snapshot()`` produces a
plain dict consumed by ``repro_torch.core.controller`` — keys are part of the policy
API and documented there.

Updates are deliberately lock-free: counters ride the GIL the same way
``BarrierConn``'s pause flag does, so the data fast path pays a couple of
clock reads and float ops, never a mutex. Telemetry is advisory — a rare lost
increment under thread races is acceptable, and ``snapshot()`` sees a
consistent-enough view for threshold policies.
"""
from __future__ import annotations

import statistics
import time
from typing import Any, Callable, Dict, Optional


class Ewma:
    """Exponentially weighted moving average; ``value`` is None until fed."""

    __slots__ = ("alpha", "value")

    def __init__(self, alpha: float = 0.2):
        self.alpha = alpha
        self.value: Optional[float] = None

    def update(self, x: float) -> float:
        v = self.value
        self.value = x if v is None else v + self.alpha * (x - v)
        return self.value


class EwmaQuantile:
    """Incremental quantile tracking (Robbins–Monro stochastic approximation).

    The estimate moves up by ``step * q`` on samples above it and down by
    ``step * (1 - q)`` on samples below; at equilibrium a fraction ``q`` of
    samples fall below the estimate. ``step`` is scaled by an EWMA of the
    absolute deviation so the estimator adapts to the signal's magnitude
    without configuration.
    """

    __slots__ = ("q", "alpha", "value", "_spread")

    def __init__(self, q: float, alpha: float = 0.1):
        assert 0.0 < q < 1.0, q
        self.q = q
        self.alpha = alpha
        self.value: Optional[float] = None
        self._spread = Ewma(alpha)

    def update(self, x: float) -> float:
        if self.value is None:
            self.value = x
            self._spread.update(abs(x) * 0.1 + 1e-12)
            return x
        spread = self._spread.update(abs(x - self.value))
        step = self.alpha * max(spread, 1e-12)
        if x > self.value:
            self.value += step * self.q
        elif x < self.value:
            self.value -= step * (1.0 - self.q)
        return self.value


def _batch_bucket(n: int) -> str:
    """Power-of-two histogram bucket label for a batch size."""
    if n <= 0:
        return "0"
    if n == 1:
        return "1"
    lo = 1 << (n.bit_length() - 1)
    return f"{lo}-{lo * 2 - 1}"


class ConnTelemetry:
    """Per-connection (or per-job) counters feeding the policy engine.

    The data plane calls the ``record_*`` methods; the control plane calls
    ``snapshot()`` once per controller tick. Rates (``ops_per_s`` /
    ``bytes_per_s``) are measured over the interval since the previous
    snapshot, so exactly one consumer (the controller) should snapshot a given
    telemetry object.
    """

    def __init__(self, *, now: Callable[[], float] = time.monotonic):
        self._now = now
        self.created_at = now()
        # totals
        self.ops = 0              # completed data-plane operations (send batches / rtts / steps)
        self.msgs_out = 0
        self.msgs_in = 0
        self.bytes_out = 0
        self.bytes_in = 0
        self.wire_bytes = 0       # explicitly accounted wire/DCN bytes (trainer plane)
        self.steps = 0
        # latency estimators
        self.op_mean = Ewma(0.2)
        self.op_p50 = EwmaQuantile(0.50)
        self.op_p95 = EwmaQuantile(0.95)
        self.rtt_p50 = EwmaQuantile(0.50)
        self.rtt_p95 = EwmaQuantile(0.95)
        # batch shape of the data plane (docs/architecture.md §8): power-of-two
        # msgs-per-send histogram + incremental batch-size quantiles, so cost
        # models and fleet aggregates can tell a per-message regime (batch=1)
        # from a vectorized one
        self.batch_hist: Dict[str, int] = {}
        self.batch_p50 = EwmaQuantile(0.50)
        self.batch_p95 = EwmaQuantile(0.95)
        # per-pod step-time EWMAs (straggler detection)
        self._pods: Dict[str, Ewma] = {}
        # reconfig blip stats folded in live from the owning handle
        self._reconfig_stats: Any = None
        # snapshot window
        self._win_t = self.created_at
        self._win_ops = 0
        self._win_bytes = 0

    # -- recording --------------------------------------------------------------
    def record_send(self, n_msgs: int, n_bytes: int, dt_s: float) -> None:
        self.ops += 1
        self.msgs_out += n_msgs
        self.bytes_out += n_bytes
        self.op_mean.update(dt_s)
        self.op_p50.update(dt_s)
        self.op_p95.update(dt_s)
        b = _batch_bucket(n_msgs)
        self.batch_hist[b] = self.batch_hist.get(b, 0) + 1
        self.batch_p50.update(float(n_msgs))
        self.batch_p95.update(float(n_msgs))

    def record_recv(self, n_msgs: int, n_bytes: int) -> None:
        self.msgs_in += n_msgs
        self.bytes_in += n_bytes

    def record_rtt(self, dt_s: float) -> None:
        """Application-observed round-trip latency (e.g. a KV request)."""
        self.rtt_p50.update(dt_s)
        self.rtt_p95.update(dt_s)

    def record_wire(self, n_bytes: int) -> None:
        """Explicit wire-byte accounting for planes whose bytes do not pass
        through send() (the jitted step's DCN traffic)."""
        self.wire_bytes += n_bytes

    def record_step(self, reports: Dict[str, float]) -> None:
        """One training step's heartbeat reports, ``{pod: step_time_s}``.
        Counts one step/op regardless of how many pods report — per-pod
        counting would inflate ``steps`` and step-driven rates by the pod
        count."""
        self.steps += 1
        self.ops += 1
        for pod, dt_s in reports.items():
            self._pods.setdefault(pod, Ewma(0.3)).update(dt_s)

    def bind_reconfig(self, stats: Any) -> None:
        """Fold a live ``ReconfigStats`` into every snapshot (duck-typed:
        needs .switches / .last_switch_s / .total_blocked_s)."""
        self._reconfig_stats = stats

    # -- derived signals --------------------------------------------------------
    def pod_step_times(self) -> Dict[str, float]:
        return {p: e.value for p, e in self._pods.items() if e.value is not None}

    def straggler_ratio(self) -> float:
        """Slowest pod's step-time EWMA over the median of the OTHER pods' —
        1.0 means no straggler; needs at least two reporting pods to be
        meaningful. The straggler is excluded from its own baseline: with the
        straggler in the denominator a 2-pod job could never exceed 2.0 (a
        3x straggler would read exactly 1.5), capping what thresholds are
        reachable."""
        times = sorted(self.pod_step_times().values())
        if len(times) < 2:
            return 1.0
        slowest, rest = times[-1], times[:-1]
        base = statistics.median(rest)
        return slowest / base if base > 0 else 1.0

    def snapshot(self, *, reset_window: bool = True) -> dict:
        """One consistent-enough view of every signal, as a plain dict — the
        input to ``ReconfigController.tick`` and the scoring functions in
        ``repro_torch.core.cost``.

        Keys (all part of the policy API): totals (``ops``, ``steps``,
        ``msgs_out``/``msgs_in``, ``bytes_out``/``bytes_in``, ``wire_bytes``),
        windowed rates (``ops_per_s``, ``bytes_per_s`` — measured since the
        previous window reset — plus ``window_s``, the measured window
        length, so ``ops_per_s * window_s`` reconstructs the exact op count
        handed to this window), latency estimates (``op_mean_s``,
        ``op_p50_s``/``op_p95_s``, ``rtt_p50_s``/``rtt_p95_s``; None until
        fed), batch shape (``batch_hist`` — power-of-two msgs-per-send
        histogram, ``batch_p50``/``batch_p95``, ``msgs_per_op``), the step
        plane (``pods``, ``step_time_s``, ``straggler_ratio``), and the
        folded reconfig stats (``switches``, ``last_switch_s``,
        ``total_blocked_s``).

        ``reset_window=True`` (the controller's once-per-tick call) starts a
        new rate window; exactly ONE consumer may do that. Everyone else —
        e.g. a ServerNegotiator scoring an offer mid-window — must pass
        ``reset_window=False`` to peek without disturbing the rates.
        """
        now = self._now()
        dt = max(now - self._win_t, 1e-9)
        # Capture each shared counter EXACTLY ONCE. Recorders append
        # concurrently (plain ints riding the GIL): re-reading self.ops
        # for the window reset after the rate computation would hand any
        # increment landing between the two reads to neither window —
        # the rate of this snapshot excludes it, and the next window's
        # baseline already includes it, so the sample is lost forever.
        ops_now = self.ops
        total_bytes = self.bytes_out + self.wire_bytes
        ops_per_s = (ops_now - self._win_ops) / dt
        bytes_per_s = (total_bytes - self._win_bytes) / dt
        if reset_window:
            self._win_t = now
            self._win_ops = ops_now
            self._win_bytes = total_bytes
        rs = self._reconfig_stats
        pods = self.pod_step_times()
        return {
            "uptime_s": now - self.created_at,
            "window_s": dt,
            "ops": ops_now,
            "steps": self.steps,
            "msgs_out": self.msgs_out,
            "msgs_in": self.msgs_in,
            "bytes_out": self.bytes_out,
            "bytes_in": self.bytes_in,
            "wire_bytes": self.wire_bytes,
            "ops_per_s": ops_per_s,
            "bytes_per_s": bytes_per_s,
            "op_mean_s": self.op_mean.value,
            "op_p50_s": self.op_p50.value,
            "op_p95_s": self.op_p95.value,
            "batch_hist": dict(self.batch_hist),
            "batch_p50": self.batch_p50.value,
            "batch_p95": self.batch_p95.value,
            "msgs_per_op": self.msgs_out / self.ops if self.ops else None,
            "rtt_p50_s": self.rtt_p50.value,
            "rtt_p95_s": self.rtt_p95.value,
            "pods": pods,
            "step_time_s": statistics.median(pods.values()) if pods else None,
            "straggler_ratio": self.straggler_ratio(),
            "switches": getattr(rs, "switches", 0),
            "last_switch_s": getattr(rs, "last_switch_s", 0.0),
            "total_blocked_s": getattr(rs, "total_blocked_s", 0.0),
        }
