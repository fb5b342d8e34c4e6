"""Act fleet-wide: ONE decision over the aggregate, committed in ONE epoch.

Without this layer, Bertha's §7.3 switch is per-client: N controllers over N
``ConnTelemetry``s each cross their own threshold at their own time, and the
fleet flaps independently. Here a single ``fleet_controller`` runs the policy
once over the ``FleetAggregator`` snapshot and drives the switch through the
rendezvous transition protocol (``propose_transition``/``vote``/
``try_commit``) — every member lands on the same stack in the same epoch, and
a member that never offered the target vetoes the whole transition (the §4.2
guarantee survives at fleet scope).

``FleetMember`` is a member's fleet-facing shim around its live
``ConnHandle``: ``join()`` registers through the rendezvous (late joiners
recover and adopt the committed stack, §5.3a), and ``poll()`` — called from
the member's own loop — heartbeats its publisher, votes on any pending
proposal (accept iff the fingerprint resolves in its negotiated option set),
and applies newly committed epochs to the local handle.
"""
from __future__ import annotations

import time
from typing import Any, Callable, List, Optional, Sequence

from repro_torch.core import rendezvous
from repro_torch.core.controller import (
    PolicyContext,
    ReconfigController,
    Rule,
    policy_rules,
    stack_candidates,
)
from repro_torch.core.rendezvous import KVStore, TxnConflict
from repro_torch.fleet.publish import FleetPublisher, fleet_conn_id


class FleetMember:
    """One endpoint's membership in a fleet: publish + vote + apply.

    Args:
        store, fleet_id, member: the fleet and our name in it.
        handle: the live ``ConnHandle`` fleet transitions reconfigure.
        stack: the member's negotiated ``Stack`` — its options are what we
            can vote for and switch to (fingerprints are structural, so
            equivalent stacks match across members).
        publisher: optional ``FleetPublisher`` heartbeated by ``poll()``.
    """

    def __init__(self, store: KVStore, fleet_id: str, member: str,
                 handle: Any, stack: Any, *,
                 publisher: Optional[FleetPublisher] = None):
        self.store = store
        self.fleet_id = fleet_id
        self.conn_id = fleet_conn_id(fleet_id)
        self.member = member
        self.handle = handle
        self.stack = stack
        self.publisher = publisher
        self.epoch = 0           # last committed epoch applied locally
        self.transitions: List[dict] = []   # audit: {"epoch", "fp", "applied"}
        self._unresolved_epoch: Optional[int] = None  # logged-once failures

    # -- membership -----------------------------------------------------------
    def join(self) -> rendezvous.JoinResult:
        """Register via the rendezvous (§5.3). If a stack is already
        committed, adopt it locally — a late joiner recovers the fleet's
        configuration without having negotiated."""
        options = self.stack.options()
        fps = [opt.fingerprint() for opt in options]
        descs = [opt.describe() for opt in options]

        def _compat(committed_desc: list) -> Optional[int]:
            names = [c["name"] for c in committed_desc]
            for i, opt in enumerate(options):
                if [c.name for c in opt.chunnels] == names:
                    return i
            return None

        res = rendezvous.join(self.store, self.conn_id, self.member,
                              fps, descs, _compat)
        self._adopt(res.stack_fp, res.epoch)
        return res

    def leave(self) -> int:
        if self.publisher is not None:
            self.publisher.retire()
        return rendezvous.leave(self.store, self.conn_id, self.member)

    # -- the member's loop ----------------------------------------------------
    def poll(self, now: Optional[float] = None) -> bool:
        """One pump of the member's fleet duties: heartbeat-publish telemetry,
        re-join if the fleet evicted us (heartbeat-TTL expiry while we were
        merely stalled — see ``FleetAggregator``), vote on any pending
        proposal, apply a newly committed epoch. Returns True if this poll
        reconfigured the local handle."""
        if self.publisher is not None:
            self.publisher.maybe_publish(now)
        if self.member not in (self.store.get(f"{self.conn_id}/members") or {}):
            self.join()
        self.vote_pending()
        return self.apply_committed()

    def vote_pending(self) -> Optional[bool]:
        """Vote on an in-flight proposal we haven't acked: accept iff the
        proposed fingerprint resolves in OUR negotiated options — a member
        that cannot run the target refuses, and ``try_commit`` aborts the
        whole transition (no member can be forced onto a stack it never
        offered). Returns the vote cast, or None if nothing was pending."""
        prop = self.store.get(f"{self.conn_id}/proposal")
        if prop is None or self.member in prop.get("acks", {}):
            return None
        accept = self.stack.find(prop["fp"]) is not None
        rendezvous.vote(self.store, self.conn_id, self.member,
                        prop["epoch"], accept)
        return accept

    def apply_committed(self) -> bool:
        """Adopt the committed stack if its epoch is newer than what we run."""
        cur = rendezvous.current_stack(self.store, self.conn_id)
        if cur is None or cur["epoch"] <= self.epoch:
            return False
        return self._adopt(cur["fp"], cur["epoch"])

    def _adopt(self, fp: str, epoch: int) -> bool:
        """Try to run the committed ``fp``; advance ``self.epoch`` ONLY when
        we actually run it. A fingerprint that doesn't resolve in our options
        (possible for a joiner whose stack matched the committed one by
        chunnel names but not fingerprints) must not be silently marked
        adopted — the epoch stays behind, the divergence is visible in
        ``transitions``, and any later committed epoch is still picked up."""
        if self.handle.stack.fingerprint() == fp:
            self.epoch = epoch
            return False
        opt = self.stack.find(fp)
        applied = opt is not None and bool(self.handle.reconfigure(opt))
        if applied:
            self.epoch = epoch
            self.transitions.append({"epoch": epoch, "fp": fp, "applied": True})
        elif self._unresolved_epoch != epoch:     # log the failure once
            self._unresolved_epoch = epoch
            self.transitions.append({"epoch": epoch, "fp": fp, "applied": False})
        return applied


def fleet_controller(
    store: KVStore,
    fleet_id: str,
    stack: Any,
    rules: Optional[Sequence[Rule]] = None,
    *,
    policy: Optional[str] = None,
    policy_params: Optional[dict] = None,
    default: Any = None,
    coordinator: str = "fleet-controller",
    vote_timeout_s: float = 2.0,
    retry_backoff_s: Optional[float] = None,
    pump: Optional[Callable[[], Any]] = None,
    poll_s: float = 0.002,
    **kw,
) -> ReconfigController:
    """A ``ReconfigController`` whose decisions commit FLEET-WIDE.

    Tick it with ``FleetAggregator.aggregate()`` snapshots. Pass EITHER an
    explicit ``rules`` list OR a registered ``policy`` name (the factory sees
    ``stack``'s options as scoreable candidates, exactly like
    ``conn_controller``). ``current()`` reads the committed fleet stack from
    the rendezvous, so the controller is stateless across restarts — a new
    coordinator picks up where the last one left off.

    ``switch(target)`` publishes a ``propose_transition``, then waits for the
    members' votes: ``pump`` (when given) is invoked while waiting — drive
    the members' ``poll()`` from it in single-threaded loops and tests;
    without it the members are expected to poll from their own threads and we
    sleep ``poll_s`` between ``try_commit`` attempts. A concurrent proposal
    (``TxnConflict``) or any member's refusal reports the switch as
    not-committed. The controller's ``cooldown_s`` only damps COMMITTED
    switches, so failed attempts carry their own damping: after one, no new
    proposal is published for ``retry_backoff_s`` (default ``vote_timeout_s``)
    — an armed rule cannot drive a propose/abort storm, and a silent member
    costs at most one ``vote_timeout_s`` wait per backoff window.
    """
    if (rules is None) == (policy is None):
        raise ValueError("pass exactly one of rules= or policy=")
    if policy is not None:
        ctx = PolicyContext(candidates=stack_candidates(stack),
                            default=default,
                            params=dict(policy_params or {}))
        rules = policy_rules(policy, ctx)
    conn_id = fleet_conn_id(fleet_id)
    backoff_s = vote_timeout_s if retry_backoff_s is None else retry_backoff_s
    last_failed_at: List[float] = []

    def current() -> str:
        cur = rendezvous.current_stack(store, conn_id)
        return cur["fp"] if cur else stack.preferred().fingerprint()

    def switch(target: Any) -> bool:
        if last_failed_at and time.monotonic() - last_failed_at[0] < backoff_s:
            return False   # failed-attempt damping; see docstring
        try:
            epoch = rendezvous.propose_transition(
                store, conn_id, coordinator,
                target.fingerprint(), target.describe())
        except (TxnConflict, ValueError):
            # a transition is in flight, or no fleet has joined yet
            last_failed_at[:] = [time.monotonic()]
            return False
        t0 = time.monotonic()
        while True:
            if pump is not None:
                pump()
            r = rendezvous.try_commit(store, conn_id, epoch,
                                      vote_timeout_s, t0)
            if r is not None:
                if pump is not None:
                    pump()   # let members apply the committed epoch promptly
                if r:
                    last_failed_at.clear()
                else:
                    last_failed_at[:] = [time.monotonic()]
                return bool(r)
            if pump is None:
                time.sleep(poll_s)

    return ReconfigController(rules, switch, current, **kw)
