"""Rendezvous-based multi-party negotiation (Bertha §5.3).

A key-value store with serializable multi-key transactions records each
multi-endpoint connection's negotiated datapath stack, so endpoints can
(a) recover the stack without having participated in negotiation, and
(b) propose transitions that commit via two-phase agreement among the
current participants.

The in-memory store mirrors the Redis/etcd interface the paper assumes
(compare-and-swap inside a transaction); it can be sharded per connection-id
since negotiation state is never shared across connections.

Two transaction disciplines:

  transact        PESSIMISTIC — ``fn`` runs with the store lock held; never
                  conflicts. Right for short control-plane transactions
                  (join/vote/commit), whose critical sections are tiny.
  try_transact    OPTIMISTIC — ``fn`` runs against a read-tracking snapshot
                  view with NO lock held; the commit re-acquires the lock,
                  validates every read key's version, and raises
                  ``TxnConflict`` if another writer interleaved.
                  ``transact_retry`` wraps it with bounded backoff. Right for
                  the fleet signal plane, where many publishers read-modify-
                  write a shared roster concurrently and must not serialize
                  their (snapshot-building) work behind one global lock.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple


class TxnConflict(RuntimeError):
    pass


class KVStore:
    """Versioned KV store with serializable multi-key transactions."""

    def __init__(self):
        self._data: Dict[str, Any] = {}
        self._ver: Dict[str, int] = {}
        self._lock = threading.RLock()
        #: optimistic commits rejected because a read key's version moved —
        #: observability for contention tests and the fleet publisher
        self.conflicts = 0

    def get(self, key: str) -> Any:
        with self._lock:
            return self._data.get(key)

    def version(self, key: str) -> int:
        with self._lock:
            return self._ver.get(key, 0)

    def read_versioned(self, key: str) -> Tuple[Any, int]:
        """(value, version) read atomically — the unit of optimistic reads."""
        with self._lock:
            return self._data.get(key), self._ver.get(key, 0)

    def keys(self, prefix: str = "") -> List[str]:
        """All live keys under ``prefix`` (the etcd range-scan analogue) —
        fleet debugging/tooling; membership itself is roster-driven (the
        roster and member records are written in one atomic txn)."""
        with self._lock:
            return sorted(k for k in self._data if k.startswith(prefix))

    def transact(self, fn: Callable[["Txn"], Any]) -> Any:
        """Run fn against a serializable view; commits atomically."""
        with self._lock:
            txn = Txn(self)
            # lint: allow[blocking-under-lock] pessimistic discipline (module docstring): fn is a tiny control-plane txn body (join/vote/commit) and MUST run serialized under the store lock
            out = fn(txn)
            self._apply(txn)
            return out

    def try_transact(self, fn: Callable[["Txn"], Any]) -> Any:
        """One OPTIMISTIC attempt: ``fn`` runs against a snapshot view without
        the store lock (first read of each key pins its value+version for the
        rest of the transaction); the commit validates that no read key's
        version moved and raises ``TxnConflict`` otherwise. ``fn`` must be
        pure against the txn view — it may run several times under
        ``transact_retry``."""
        txn = Txn(self, track_reads=True)
        out = fn(txn)
        with self._lock:
            for k, ver in txn.reads.items():
                if self._ver.get(k, 0) != ver:
                    self.conflicts += 1
                    raise TxnConflict(
                        f"key {k!r} moved to v{self._ver.get(k, 0)} "
                        f"(read at v{ver})")
            self._apply(txn)
            return out

    def transact_retry(self, fn: Callable[["Txn"], Any], *,
                       max_retries: int = 32, backoff_s: float = 2e-4,
                       on_conflict: Optional[Callable[[], None]] = None) -> Any:
        """``try_transact`` with bounded linear-backoff retries; the standard
        wrapper for contended read-modify-write (fleet publishers updating the
        shared roster). ``on_conflict`` fires once per retried conflict."""
        for attempt in range(max_retries + 1):
            try:
                return self.try_transact(fn)
            except TxnConflict:
                if on_conflict is not None:
                    on_conflict()
                if attempt == max_retries:
                    raise
                time.sleep(backoff_s * (attempt + 1))

    def _apply(self, txn: "Txn") -> None:  # lint: allow[unguarded-attr] every caller (transact/try_transact) holds self._lock; RLock makes taking it here redundant, not wrong — kept out of the hot commit path
        for k, v in txn.writes.items():
            self._data[k] = v
            self._ver[k] = self._ver.get(k, 0) + 1
        for k in txn.deletes:
            self._data.pop(k, None)
            self._ver[k] = self._ver.get(k, 0) + 1

    def compare_and_swap(self, key: str, expect_version: int, value: Any) -> bool:
        with self._lock:
            if self._ver.get(key, 0) != expect_version:
                return False
            self._data[key] = value
            self._ver[key] = expect_version + 1
            return True


class Txn:
    def __init__(self, store: KVStore, *, track_reads: bool = False):
        self._store = store
        self._track = track_reads
        self.writes: Dict[str, Any] = {}
        self.deletes: set = set()
        self.reads: Dict[str, int] = {}     # key -> version at first read
        self._read_cache: Dict[str, Any] = {}

    def get(self, key: str) -> Any:
        if key in self.writes:
            return self.writes[key]
        if key in self.deletes:
            return None
        if self._track:
            # snapshot view: first read pins (value, version) for the txn
            if key not in self.reads:
                val, ver = self._store.read_versioned(key)
                self.reads[key] = ver
                self._read_cache[key] = val
            return self._read_cache[key]
        return self._store._data.get(key)

    def put(self, key: str, value: Any) -> None:
        self.deletes.discard(key)
        self.writes[key] = value

    def delete(self, key: str) -> None:
        self.writes.pop(key, None)
        self.deletes.add(key)


# ---------------------------------------------------------------------------
# Multi-party negotiation protocol
# ---------------------------------------------------------------------------


@dataclass
class JoinResult:
    stack_fp: str
    stack_desc: list
    participants: int
    epoch: int
    proposed: bool  # True if we were first and our proposal committed


def join(store: KVStore, conn_id: str, member: str, offer_fps: List[str],
         offer_descs: List[list], caps_compatible: Callable[[list], Optional[int]]) -> JoinResult:
    """Join a multi-endpoint connection (§5.3).

    Proposes our preferred stack with CAS; if a stack is already in place,
    checks compatibility (caps_compatible returns the index of our first
    compatible option against the committed stack, or None)."""

    def _fn(txn: Txn) -> JoinResult:
        cur = txn.get(f"{conn_id}/stack")
        if cur is None:
            txn.put(f"{conn_id}/stack", {
                "fp": offer_fps[0], "desc": offer_descs[0], "epoch": 1,
            })
            txn.put(f"{conn_id}/members", {member: 1})
            return JoinResult(offer_fps[0], offer_descs[0], 1, 1, True)
        idx = caps_compatible(cur["desc"])
        if idx is None:
            raise ValueError(
                f"{member}: no offered stack compatible with committed stack of {conn_id}"
            )
        members = dict(txn.get(f"{conn_id}/members") or {})
        members[member] = cur["epoch"]
        txn.put(f"{conn_id}/members", members)
        return JoinResult(cur["fp"], cur["desc"], len(members), cur["epoch"], False)

    return store.transact(_fn)


def leave(store: KVStore, conn_id: str, member: str) -> int:
    def _fn(txn: Txn) -> int:
        members = dict(txn.get(f"{conn_id}/members") or {})
        members.pop(member, None)
        txn.put(f"{conn_id}/members", members)
        return len(members)

    return store.transact(_fn)


def current_stack(store: KVStore, conn_id: str) -> Optional[dict]:
    """Late joiners recover the stack without having negotiated (§5.3a)."""
    return store.get(f"{conn_id}/stack")


# -- two-phase transition ----------------------------------------------------


def propose_transition(store: KVStore, conn_id: str, proposer: str,
                       new_fp: str, new_desc: list) -> int:
    """Phase 1: publish a proposal; returns the proposal epoch."""

    def _fn(txn: Txn) -> int:
        cur = txn.get(f"{conn_id}/stack")
        if cur is None:
            raise ValueError("no such connection")
        if txn.get(f"{conn_id}/proposal") is not None:
            raise TxnConflict("a transition is already in flight")
        epoch = cur["epoch"] + 1
        txn.put(f"{conn_id}/proposal", {
            "fp": new_fp, "desc": new_desc, "epoch": epoch,
            "proposer": proposer, "acks": {proposer: True},
        })
        return epoch

    return store.transact(_fn)


def vote(store: KVStore, conn_id: str, member: str, epoch: int, accept: bool) -> None:
    def _fn(txn: Txn) -> None:
        prop = txn.get(f"{conn_id}/proposal")
        if prop is None or prop["epoch"] != epoch:
            return
        acks = dict(prop["acks"])
        acks[member] = accept
        txn.put(f"{conn_id}/proposal", {**prop, "acks": acks})

    store.transact(_fn)


def try_commit(store: KVStore, conn_id: str, epoch: int,
               timeout_s: float, t0: Optional[float] = None) -> Optional[bool]:
    """Phase 2: commit iff ALL members acked; abort on any refusal or timeout.
    A faulty peer can therefore never force others to switch (§4.2 fn. 3).
    Returns True committed / False aborted / None still pending."""
    t0 = t0 if t0 is not None else time.monotonic()

    def _fn(txn: Txn) -> Optional[bool]:
        prop = txn.get(f"{conn_id}/proposal")
        if prop is None or prop["epoch"] != epoch:
            return False
        members = txn.get(f"{conn_id}/members") or {}
        acks = prop["acks"]
        if any(acks.get(m) is False for m in members):
            txn.delete(f"{conn_id}/proposal")
            return False
        if all(acks.get(m) for m in members):
            txn.put(f"{conn_id}/stack", {
                "fp": prop["fp"], "desc": prop["desc"], "epoch": prop["epoch"],
            })
            txn.delete(f"{conn_id}/proposal")
            return True
        if time.monotonic() - t0 > timeout_s:
            txn.delete(f"{conn_id}/proposal")
            return False
        return None

    return store.transact(_fn)
