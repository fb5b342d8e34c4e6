"""Metrics federation: every process's registry merged over the KV fabric.

The ``MetricsRegistry`` stops at the process boundary. This module ships
each process's ``collect()`` snapshot through the same KV plane the fleet
control loop already uses — versioned, heartbeat-stamped records with
optimistic-transaction publishing (``FleetPublisher``) and heartbeat-age
staleness (``FleetAggregator``) — under a separate ``obs/`` key prefix so
metrics traffic never collides with rendezvous coordination state.

* :class:`MetricsPublisher` — a ``FleetPublisher`` whose record payload is
  ``{"region", "metrics": registry.collect()}`` instead of a flat telemetry
  snapshot. Call ``maybe_publish()`` from any convenient loop; it is the
  heartbeat.
* :class:`MetricsFederator` — reads all fresh member records and folds them
  into ONE fleet-wide view. Merge rules are name-driven, mirroring the
  fleet aggregator's quantile hygiene: upper quantiles (p95/p99/max/age)
  take the max across members — the conservative combine, a fleet is as
  slow as its slowest member; central/ratio statistics (p50/mean/ratio)
  take the load-weighted mean; everything else (counters, rates) sums.

The federated view is exposed three ways: ``view()`` (flat ``obs.*`` keys
for SLO engines and policy predicates, including per-region breakdowns),
``federated_registry()`` (a point-in-time ``MetricsRegistry`` whose
instances are ``member/instance``-labeled plus a ``_fleet`` merged row —
reusing the stock JSON/Prometheus exporters verbatim), and the
``SignalSource`` protocol (``read()``), so a ``FleetAggregator`` or
controller can merge ``obs.*`` keys like any other signal feed.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

from repro_torch.core.rendezvous import KVStore
from repro_torch.fleet.aggregate import FleetAggregator
from repro_torch.fleet.publish import FleetPublisher
from repro_torch.obs.metrics import MetricsRegistry

__all__ = ["MetricsPublisher", "MetricsFederator", "OBS_PLANE"]

#: KV key prefix for the observability plane (vs ``"fleet"`` coordination).
OBS_PLANE = "obs"

# merge-mode vocabularies: substring match on the flattened metric key
_MAX_TOKENS = ("p95", "p99", "p999", "max", "age", "imbalance", "uptime")
_MEAN_TOKENS = ("p50", "p10", "mean", "avg", "ratio", "frac", "per_op",
                "utilization")


class MetricsPublisher(FleetPublisher):
    """Publish one process's ``MetricsRegistry`` snapshot to the obs plane.

    Args:
        store, fleet_id, member: where and as whom to publish.
        registry: the process-local ``MetricsRegistry``.
        region: breakdown label for ``MetricsFederator.per_region`` /
            ``obs.region.<region>.*`` keys.
        period_s / max_retries / now: as ``FleetPublisher``.

    Registered sources must sample non-destructively — wrap a
    ``ConnTelemetry`` as ``lambda: t.snapshot(reset_window=False)`` rather
    than ``registry.watch``-ing it directly, or publishing would steal the
    local controller's rate window.
    """

    def __init__(self, store: KVStore, fleet_id: str, member: str,
                 registry: MetricsRegistry, *, region: str = "default",
                 period_s: float = 0.05, max_retries: int = 32,
                 now: Callable[[], float] = time.monotonic):
        super().__init__(store, fleet_id, member, telemetry=registry,
                         period_s=period_s, reset_window=False,
                         max_retries=max_retries, plane=OBS_PLANE, now=now)
        self.registry = registry
        self.region = region

    def _snapshot(self) -> Dict[str, Any]:
        return {"region": self.region, "metrics": self.registry.collect()}


# one flattened sample: (member, region, family, key, value, weight)
_Row = Tuple[str, str, str, str, float, float]


def _as_float(val: Any) -> Optional[float]:
    if isinstance(val, bool):
        return float(val)
    if isinstance(val, (int, float)):
        return float(val)
    return None


def _merge_mode(key: str) -> str:
    k = key.lower()
    if any(t in k for t in _MAX_TOKENS):
        return "max"
    if any(t in k for t in _MEAN_TOKENS):
        return "mean"
    return "sum"


def _flatten(metrics: Mapping[str, Mapping[str, Any]]
             ) -> List[Tuple[str, str, float]]:
    """``registry.collect()``'s ``{family: {instance: {key: val}}}`` down to
    ``[(family, key, value)]``; one-level nested dicts become dotted keys,
    non-numerics (incl. ``_error`` markers) are dropped from the merge —
    they stay visible in the per-member JSON."""
    rows: List[Tuple[str, str, float]] = []
    for family, insts in metrics.items():
        for metrics_d in insts.values():
            if not isinstance(metrics_d, Mapping):
                continue
            for key, val in metrics_d.items():
                if key.startswith("_"):
                    continue
                if isinstance(val, Mapping):
                    for sub, sv in val.items():
                        num = _as_float(sv)
                        if num is not None:
                            rows.append((family, f"{key}.{sub}", num))
                    continue
                num = _as_float(val)
                if num is not None:
                    rows.append((family, key, num))
    return rows


def _fold(rows: List[_Row]) -> Dict[str, Dict[str, float]]:
    """Merge flattened rows into ``{family: {key: value}}`` by mode."""
    acc: Dict[Tuple[str, str], List[Tuple[float, float]]] = {}
    for _m, _r, family, key, val, weight in rows:
        acc.setdefault((family, key), []).append((val, weight))
    out: Dict[str, Dict[str, float]] = {}
    for (family, key), pairs in acc.items():
        mode = _merge_mode(key)
        if mode == "max":
            v = max(p[0] for p in pairs)
        elif mode == "mean":
            wsum = sum(w for _, w in pairs)
            v = (sum(x * w for x, w in pairs) / wsum if wsum > 0
                 else sum(x for x, _ in pairs) / len(pairs))
        else:
            v = sum(x for x, _ in pairs)
        out.setdefault(family, {})[key] = v
    return out


class MetricsFederator:
    """Fold obs-plane member records into one fleet-wide metrics view.

    Args:
        store, fleet_id: where the ``MetricsPublisher``s write.
        ttl_s: heartbeat age beyond which a member is stale (and, with
            ``expire=True``, physically removed — obs-plane expiry never
            touches rendezvous membership).
        now: clock override for deterministic tests.
    """

    name = "obs"  # SignalSource protocol

    def __init__(self, store: KVStore, fleet_id: str, *, ttl_s: float = 1.0,
                 expire: bool = True,
                 now: Callable[[], float] = time.monotonic):
        self.fleet_id = fleet_id
        self._now = now
        self._agg = FleetAggregator(store, fleet_id, ttl_s=ttl_s,
                                    expire=expire, plane=OBS_PLANE, now=now)

    # -- raw member view -------------------------------------------------------
    def members(self, now: Optional[float] = None
                ) -> Tuple[Dict[str, dict], List[str]]:
        """(fresh records by member, stale member names)."""
        return self._agg.member_records(now)

    @property
    def expired_total(self) -> int:
        return self._agg.expired_total

    def _rows(self, fresh: Dict[str, dict]) -> List[_Row]:
        rows: List[_Row] = []
        for member, rec in fresh.items():
            snap = rec.get("snapshot") or {}
            region = snap.get("region") or "default"
            flat = _flatten(snap.get("metrics") or {})
            # load weight for mean merges: the member's op rate if its
            # metrics carry one, else uniform
            weight = sum(v for _f, k, v in flat if k.endswith("ops_per_s"))
            weight = weight if weight > 0 else 1.0
            rows.extend((member, region, f, k, v, weight)
                        for f, k, v in flat)
        return rows

    # -- merged views ----------------------------------------------------------
    def merged(self, now: Optional[float] = None
               ) -> Dict[str, Dict[str, float]]:
        """Fleet-wide ``{family: {key: value}}`` across all fresh members."""
        fresh, _stale = self.members(now)
        return _fold(self._rows(fresh))

    def per_region(self, now: Optional[float] = None
                   ) -> Dict[str, Dict[str, Dict[str, float]]]:
        """``{region: {family: {key: value}}}`` breakdown."""
        fresh, _stale = self.members(now)
        by_region: Dict[str, List[_Row]] = {}
        for row in self._rows(fresh):
            by_region.setdefault(row[1], []).append(row)
        return {region: _fold(rows) for region, rows in by_region.items()}

    def view(self, now: Optional[float] = None) -> Dict[str, Any]:
        """One flat ``obs.*`` dict — the SLO engine's and policy layer's
        input. Keys: ``obs.members``/``obs.stale_members``/
        ``obs.availability``/``obs.heartbeat_age_s``, fleet-merged
        ``obs.<family>.<key>``, per-region
        ``obs.region.<region>.<family>.<key>``, and the
        ``obs.member_ops_per_s`` load-weight detail."""
        now = self._now() if now is None else now
        fresh, stale = self.members(now)
        rows = self._rows(fresh)
        total = len(fresh) + len(stale)
        out: Dict[str, Any] = {
            "obs.members": len(fresh),
            "obs.stale_members": len(stale),
            "obs.availability": (len(fresh) / total) if total else 1.0,
            "obs.heartbeat_age_s": (max(now - rec.get("at", now)
                                        for rec in fresh.values())
                                    if fresh else None),
        }
        for family, keys in _fold(rows).items():
            for key, val in keys.items():
                out[f"obs.{family}.{key}"] = val
        by_region: Dict[str, List[_Row]] = {}
        for row in rows:
            by_region.setdefault(row[1], []).append(row)
        for region, rrows in by_region.items():
            for family, keys in _fold(rrows).items():
                for key, val in keys.items():
                    out[f"obs.region.{region}.{family}.{key}"] = val
        weights: Dict[str, float] = {}
        for member, _r, _f, key, val, _w in rows:
            if key.endswith("ops_per_s"):
                weights[member] = weights.get(member, 0.0) + val
        out["obs.member_ops_per_s"] = weights
        return out

    # -- SignalSource protocol -------------------------------------------------
    def read(self, now: Optional[float] = None) -> Dict[str, Any]:
        return self.view(now)

    # -- exporter bridge -------------------------------------------------------
    def federated_registry(self, now: Optional[float] = None
                           ) -> MetricsRegistry:
        """A point-in-time ``MetricsRegistry`` over the federated snapshot.

        Per-member sources keep their family but are re-instanced as
        ``<member>/<original instance>``; the fleet-merged fold is added
        under instance ``_fleet``. The stock ``to_prometheus`` then emits
        multi-member-labeled samples with no new exporter code.
        """
        reg = MetricsRegistry()
        fresh, _stale = self.members(now)
        for member, rec in sorted(fresh.items()):
            snap = rec.get("snapshot") or {}
            for family, insts in (snap.get("metrics") or {}).items():
                for inst, metrics in insts.items():
                    reg.register(family, lambda m=metrics: m,
                                 instance=f"{member}/{inst}")
        for family, keys in _fold(self._rows(fresh)).items():
            reg.register(family, lambda m=keys: m, instance="_fleet")
        return reg
