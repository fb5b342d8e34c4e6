"""Publish: each fleet member's telemetry into the rendezvous KV store.

A ``FleetPublisher`` attaches to one ``ConnTelemetry`` (a serving client's
connection, a trainer job) and periodically writes a versioned,
heartbeat-stamped snapshot record under the fleet's key prefix:

  fleet/<fleet_id>/roster            {member: last_heartbeat}
  fleet/<fleet_id>/member/<name>     {member, seq, at, snapshot}

Records are written with the store's OPTIMISTIC transactions
(``KVStore.try_transact``): the roster is a shared read-modify-write, and N
publishers updating it concurrently is exactly the lost-update hazard the
version validation catches — conflicting publishers retry with backoff
(``publisher.conflicts`` counts them; tests drive this deliberately).

Staleness is by heartbeat AGE, not presence: a member that dies simply stops
stamping ``at``, and the ``FleetAggregator`` drops (and optionally expires)
it once the age exceeds the fleet TTL — no failure detector, no leases.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional

from repro_torch.core.rendezvous import KVStore, TxnConflict


def fleet_conn_id(fleet_id: str) -> str:
    """The rendezvous connection id a fleet coordinates under — its committed
    stack/epoch lives at ``fleet/<fleet_id>/stack`` via the ordinary
    ``propose_transition``/``vote``/``try_commit`` machinery."""
    return f"fleet/{fleet_id}"


def roster_key(fleet_id: str, plane: str = "fleet") -> str:
    return f"{plane}/{fleet_id}/roster"


def member_key(fleet_id: str, member: str, plane: str = "fleet") -> str:
    return f"{plane}/{fleet_id}/member/{member}"


class FleetPublisher:
    """Periodically publish one member's telemetry snapshot into the fleet.

    Args:
        store, fleet_id, member: where and as whom to publish.
        telemetry: the ``ConnTelemetry`` to snapshot.
        period_s: minimum gap between publishes for ``maybe_publish`` (0 means
            every call); ``publish()`` always publishes.
        reset_window: whether our snapshot starts a new telemetry rate window.
            True when the publisher is the telemetry's ONLY snapshot consumer
            (fleet-managed connections with no local controller); False when a
            local controller also ticks this telemetry — rates then cover the
            interval since ITS last tick, and the two consumers don't fight
            over the window (see ``ConnTelemetry.snapshot``).
        plane: key-prefix namespace. The default ``"fleet"`` plane doubles as
            the rendezvous coordination prefix; the observability federation
            publishes metrics snapshots under ``"obs"`` so the two record
            streams never collide in one store.
        now: clock override for deterministic tests.
    """

    def __init__(self, store: KVStore, fleet_id: str, member: str,
                 telemetry: Any, *, period_s: float = 0.05,
                 reset_window: bool = True, max_retries: int = 32,
                 plane: str = "fleet",
                 now: Callable[[], float] = time.monotonic):
        self.store = store
        self.fleet_id = fleet_id
        self.member = member
        self.telemetry = telemetry
        self.period_s = period_s
        self.reset_window = reset_window
        self.max_retries = max_retries
        self.plane = plane
        self._now = now
        self.key = member_key(fleet_id, member, plane)
        self.roster = roster_key(fleet_id, plane)
        self.seq = 0            # version of OUR record (monotonic per member)
        self.published = 0
        self.conflicts = 0      # optimistic retries we personally paid
        self._last_pub: Optional[float] = None

    def publish(self, extra: Optional[Dict[str, Any]] = None,
                now: Optional[float] = None) -> dict:
        """Snapshot the telemetry and write the member record; returns the
        record. ``extra`` keys are merged into the snapshot (per-member
        signals the telemetry doesn't carry, e.g. a locally probed value)."""
        now = self._now() if now is None else now
        snap = self._snapshot()
        if extra:
            snap.update(extra)
        self.seq += 1
        rec = {"member": self.member, "seq": self.seq, "at": now,
               "snapshot": snap}

        def _fn(txn):
            roster = dict(txn.get(self.roster) or {})
            roster[self.member] = now
            txn.put(self.roster, roster)
            txn.put(self.key, rec)

        self.store.transact_retry(
            _fn, max_retries=self.max_retries,
            on_conflict=self._count_conflict)
        self.published += 1
        self._last_pub = now
        return rec

    def _snapshot(self) -> Dict[str, Any]:
        """What one published record carries. Subclasses (e.g. the obs-plane
        ``MetricsPublisher``) override this to ship richer payloads than a
        flat telemetry snapshot."""
        return dict(self.telemetry.snapshot(reset_window=self.reset_window))

    def _count_conflict(self) -> None:
        self.conflicts += 1

    def maybe_publish(self, now: Optional[float] = None,
                      extra: Optional[Dict[str, Any]] = None) -> Optional[dict]:
        """``publish()`` if at least ``period_s`` has passed; None otherwise.
        Call it from the data-plane loop — it is the heartbeat."""
        now = self._now() if now is None else now
        if self._last_pub is not None and now - self._last_pub < self.period_s:
            return None
        return self.publish(extra, now)

    def retire(self) -> None:
        """Remove this member's record and roster entry (clean leave — a
        crashed member instead ages out by heartbeat TTL)."""
        def _fn(txn):
            roster = dict(txn.get(self.roster) or {})
            roster.pop(self.member, None)
            txn.put(self.roster, roster)
            txn.delete(self.key)

        self.store.transact_retry(_fn, max_retries=self.max_retries,
                                  on_conflict=self._count_conflict)
