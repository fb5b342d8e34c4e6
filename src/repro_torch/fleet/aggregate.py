"""Aggregate: fold member records + external signals into ONE fleet snapshot.

The output of ``FleetAggregator.aggregate()`` is a plain dict that drops
straight into the existing policy machinery (``ReconfigController.tick``,
``above``/``below`` predicates, ``ScoredTarget`` scoring) — the fleet keys
are namespaced ``fleet.*`` and external signals ``ext.*``, so one registered
policy can combine them:

    Rule("high", above("fleet.offered_qps", 200), ...)
    Rule("spike", all_of(above("ext.spot_usd_per_h", 3.0),
                         below("fleet.offered_qps", 200)), ...)

Aggregate keys (the fleet policy API):

  fleet.members             fresh member count
  fleet.stale_members       roster entries whose heartbeat age exceeded ttl_s
  fleet.offered_qps         sum of member ``ops_per_s`` — the §7.3 signal
  fleet.bytes_per_s         sum of member byte rates
  fleet.ops                 sum of member op totals
  fleet.rtt_p50_s           qps-weighted mean of member p50s (None until fed)
  fleet.rtt_p95_s           max member p95 — the conservative quantile combine
  fleet.straggler_ratio     max member straggler_ratio (trainer fleets)
  fleet.qps_imbalance       max member qps / mean member qps (serving-plane
                            straggler view; 1.0 when balanced or empty)
  fleet.member_qps          {member: qps} detail for dashboards/audits
  fleet.heartbeat_age_s     oldest fresh heartbeat's age
  fleet.switches            sum of member switch counts (blip accounting)

plus every registered ``SignalSource``'s keys, merged verbatim. A failing
source is skipped (counted in ``signal_errors``) — a flaky carbon API must
not take the control loop down with it.
"""
from __future__ import annotations

import logging
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.rendezvous import KVStore
from repro_torch.fleet.publish import fleet_conn_id, member_key, roster_key
from repro_torch.fleet.signals import SignalSource

log = logging.getLogger(__name__)


class FleetAggregator:
    """Fold fleet member records into fleet metrics; merge signal sources.

    Args:
        store, fleet_id: where the publishers write.
        ttl_s: heartbeat age beyond which a member is stale and dropped from
            the aggregate (and, with ``expire=True``, removed from the store).
        sources: initial ``SignalSource``s (``add_source`` registers more).
        expire: physically delete stale records/roster entries — AND evict
            the member from the fleet's rendezvous membership map, so a
            crashed member stops blocking ``try_commit``'s unanimous-ack
            requirement and the fleet can keep switching (an evicted member
            that comes back rejoins from its next ``FleetMember.poll``). The
            expiry transaction re-checks freshness first — a member that
            republished between our read and the txn survives.
        plane: key-prefix namespace, matching the publishers'. Only the
            default ``"fleet"`` plane carries rendezvous membership, so the
            eviction side effect of expiry is skipped on any other plane.
        now: clock override for deterministic tests.
    """

    def __init__(self, store: KVStore, fleet_id: str, *, ttl_s: float = 1.0,
                 sources: Sequence[SignalSource] = (), expire: bool = True,
                 plane: str = "fleet",
                 now: Callable[[], float] = time.monotonic):
        self.store = store
        self.fleet_id = fleet_id
        self.ttl_s = ttl_s
        self.expire = expire
        self.plane = plane
        self.sources: List[SignalSource] = list(sources)
        self._now = now
        self.signal_errors = 0
        self.expired_total = 0

    def add_source(self, source: SignalSource) -> SignalSource:
        self.sources.append(source)
        return source

    # -- member view ----------------------------------------------------------
    def member_records(self, now: Optional[float] = None
                       ) -> Tuple[Dict[str, dict], List[str]]:
        """(fresh records by member, stale member names). Stale = roster entry
        with no record or a heartbeat older than ``ttl_s``."""
        now = self._now() if now is None else now
        roster = self.store.get(roster_key(self.fleet_id, self.plane)) or {}
        fresh: Dict[str, dict] = {}
        stale: List[str] = []
        for m in roster:
            rec = self.store.get(member_key(self.fleet_id, m, self.plane))
            if rec is not None and now - rec.get("at", 0.0) <= self.ttl_s:
                fresh[m] = rec
            else:
                stale.append(m)
        if stale and self.expire:
            self._expire(stale, now)
        return fresh, stale

    def _expire(self, members: List[str], now: float) -> None:
        members_map_key = f"{fleet_conn_id(self.fleet_id)}/members"
        # rendezvous membership only exists on the coordination plane; an
        # obs-plane aggregator expires records without touching 2PC state
        evict_rdv = self.plane == "fleet"

        def _fn(txn):
            dropped = evicted = 0
            roster = dict(txn.get(roster_key(self.fleet_id, self.plane)) or {})
            rdv = dict(txn.get(members_map_key) or {}) if evict_rdv else {}
            for m in members:
                rec = txn.get(member_key(self.fleet_id, m, self.plane))
                if rec is not None and now - rec.get("at", 0.0) <= self.ttl_s:
                    continue  # republished since we looked: not stale anymore
                roster.pop(m, None)
                # also evict from the rendezvous membership map: a crashed
                # member must not block try_commit's unanimous acks forever
                if evict_rdv:
                    evicted += rdv.pop(m, None) is not None
                txn.delete(member_key(self.fleet_id, m, self.plane))
                dropped += 1
            if dropped:   # a no-op put would still bump the roster version
                txn.put(roster_key(self.fleet_id, self.plane), roster)
            if evicted:
                txn.put(members_map_key, rdv)
            return dropped

        self.expired_total += self.store.transact_retry(_fn)

    # -- the fold -------------------------------------------------------------
    def aggregate(self, now: Optional[float] = None) -> dict:
        """One fleet-wide snapshot dict (see module docstring for the keys)."""
        now = self._now() if now is None else now
        fresh, stale = self.member_records(now)
        snaps = {m: rec.get("snapshot", {}) for m, rec in fresh.items()}
        qps = {m: float(s.get("ops_per_s") or 0.0) for m, s in snaps.items()}
        total_qps = sum(qps.values())
        mean_qps = total_qps / len(qps) if qps else 0.0

        def _sum(key: str) -> float:
            return float(sum(s.get(key) or 0.0 for s in snaps.values()))

        def _max(key: str, default=None):
            vals = [s.get(key) for s in snaps.values() if s.get(key) is not None]
            return max(vals) if vals else default

        # qps-weighted p50: members carrying the load dominate the combined
        # latency estimate; uniform weights when the fleet is idle
        p50_pairs = [(qps[m], s["rtt_p50_s"]) for m, s in snaps.items()
                     if s.get("rtt_p50_s") is not None]
        if p50_pairs:
            wsum = sum(w for w, _ in p50_pairs)
            p50 = (sum(w * v for w, v in p50_pairs) / wsum if wsum > 0
                   else sum(v for _, v in p50_pairs) / len(p50_pairs))
        else:
            p50 = None

        out: Dict[str, Any] = {
            "fleet.members": len(fresh),
            "fleet.stale_members": len(stale),
            "fleet.offered_qps": total_qps,
            "fleet.bytes_per_s": _sum("bytes_per_s"),
            "fleet.ops": _sum("ops"),
            "fleet.rtt_p50_s": p50,
            "fleet.rtt_p95_s": _max("rtt_p95_s"),
            "fleet.straggler_ratio": _max("straggler_ratio", 1.0),
            "fleet.qps_imbalance": (max(qps.values()) / mean_qps
                                    if qps and mean_qps > 0 else 1.0),
            "fleet.member_qps": qps,
            "fleet.heartbeat_age_s": (max(now - rec.get("at", now)
                                          for rec in fresh.values())
                                      if fresh else None),
            "fleet.switches": int(_sum("switches")),
        }
        for src in self.sources:
            try:
                out.update(src.read(now) or {})
            except Exception as e:
                # an external feed must not take the control loop down — but
                # the failure stays diagnosable: counted in signal_errors AND
                # logged at DEBUG (the compat probe pattern), never swallowed
                log.debug("signal source %r failed: %s",
                          getattr(src, "name", "?"), e)
                self.signal_errors += 1
        return out
