"""Runtime reconfiguration (Bertha §4, §6.2).

Replacing a chunnel implementation in a live connection requires a *switch
point* after which no thread uses the old datapath or its state. Two
coordination mechanisms, both implemented and microbenchmarked
(benchmarks/bench_reconfigure.py ~ paper Fig. 10):

  LockedConn   every send/recv takes a mutex; reconfigure() holds it across
               negotiation + state migration + swap. Simple; fast-path pays a
               lock per op.
  BarrierConn  fast path reads one boolean; reconfigure() raises the flag,
               waits for all data threads to park at a barrier (stop-the-world
               moment), swaps, releases. Near-zero fast-path cost; larger
               switch blip.

Multilateral chunnels additionally run a two-phase commit across peers while
the switch-point is held (negotiation uses the connection, so the barrier/lock
must protect it — §6.2).

Invariants of the swap itself (relied on by the reconfiguration controller):
  * State migration is aligned by chunnel NAME, not stack position — stacks of
    different depth (or with reordered layers) cannot silently skip
    ``migrate_state`` for layers a positional zip would have dropped.
  * Once every 2PC peer has voted ready, the decision is COMMIT: delivery
    failures in phase 2 are swallowed (presumed commit), never propagated out
    of the switch point, so a flaky peer cannot strand the group half-committed.
    A peer that missed the commit notification does not wait for its next
    prepare: it issues an *epoch query* back to the coordinator
    (``ReconfigParticipant.needs_resync`` / ``apply_state``, pumped by the
    HostAgent loop) and applies the committed stack — or clears its prepared
    state if the proposal turned out aborted.
  * Every handle carries a ``ConnTelemetry`` (repro_torch.core.telemetry); the data
    path records op latency/bytes and the reconfig blip stats are folded into
    each telemetry snapshot.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional

from repro_torch.core.chunnel import Datapath
from repro_torch.core.fabric import approx_size
from repro_torch.core.stack import ConcreteStack
from repro_torch.core.telemetry import ConnTelemetry
from repro_torch.obs.trace import NOOP_SPAN, TRACER


@dataclass
class ReconfigStats:
    switches: int = 0
    last_switch_s: float = 0.0
    total_blocked_s: float = 0.0


class ConnHandle:
    """Shared API of both mechanisms."""

    def __init__(self, stack: ConcreteStack):
        self.stack = stack
        self.dp: Datapath = stack.instantiate()
        self.stats = ReconfigStats()
        self.telemetry = ConnTelemetry()
        self.telemetry.bind_reconfig(self.stats)

    # -- data plane -----------------------------------------------------------
    def send(self, msgs) -> None:
        raise NotImplementedError

    def recv(self, buf, timeout=None) -> int:
        raise NotImplementedError

    def _record_send(self, msgs, t0: float) -> None:
        self.telemetry.record_send(len(msgs), sum(map(approx_size, msgs)),
                                   time.perf_counter() - t0)
        if TRACER.enabled:  # batch-level record only (lint: span-in-hot-loop)
            TRACER.record_batch("conn.send", len(msgs), len(msgs))

    def _record_recv(self, buf, n: int) -> None:
        if n:
            self.telemetry.record_recv(n, sum(approx_size(m) for m in buf[:n]))
            if TRACER.enabled:
                TRACER.record_batch("conn.recv", n, n)

    # -- control plane --------------------------------------------------------
    def reconfigure(self, new_stack: ConcreteStack,
                    coordinate: Optional[Callable[[], bool]] = None) -> bool:
        """Switch the live connection to ``new_stack`` (Bertha §4.2/Fig. 3).

        Acquires the mechanism's switch point (mutex for ``LockedConn``,
        stop-the-world barrier for ``BarrierConn``), then — with no thread on
        the old datapath — migrates transferable chunnel state (aligned by
        chunnel NAME), instantiates the new stack, and swaps it in.

        Args:
            new_stack: the fully-resolved ``ConcreteStack`` to switch to,
                typically one of the negotiated Stack's options.
            coordinate: optional callback run *inside* the switch point; used
                by ``HostAgent.reconfigure_multilateral`` to run the 2PC while
                the connection is quiesced (§6.2 — negotiation uses the
                connection, so the lock/barrier must protect it). Returning
                False aborts the switch with the old stack intact.

        Returns:
            True if the swap committed; False if ``coordinate`` aborted it.
            The switch blip is recorded in ``stats.last_switch_s`` and folded
            into every telemetry snapshot.
        """
        raise NotImplementedError

    def _do_swap(self, new_stack: ConcreteStack) -> None:
        # Bertha Fig. 3: ② migrate state old -> new, ③ swap implementation.
        # Alignment is by chunnel NAME: a positional zip silently skips
        # migrate_state for trailing layers when the stacks differ in depth
        # (e.g. GradCompressed error-feedback residuals dropped when switching
        # to a shorter stack) and spuriously migrates unchanged layers that
        # merely moved position.
        sp = (TRACER.span("reconfig.swap",
                          attrs={"old": self.stack.fingerprint(),
                                 "new": new_stack.fingerprint(),
                                 "mechanism": type(self).__name__})
              if TRACER.enabled else NOOP_SPAN)
        with sp:
            old_by_name: dict = {}
            for ch in self.stack.chunnels:
                old_by_name.setdefault(ch.name, ch)
            state = {}
            for new_ch in new_stack.chunnels:
                old_ch = old_by_name.get(new_ch.name)
                if old_ch is None or type(old_ch) is not type(new_ch):
                    state.update(new_ch.migrate_state(self.dp))
            old_dp = self.dp
            self.dp = new_stack.instantiate()
            if state and hasattr(self.dp, "restore_state"):
                self.dp.restore_state(state)
            if hasattr(old_dp, "close"):
                old_dp.close()
            self.stack = new_stack
            self.stats.switches += 1
            sp.set(migrated_keys=sorted(state))


class LockedConn(ConnHandle):
    def __init__(self, stack: ConcreteStack):
        super().__init__(stack)
        self._lock = threading.Lock()

    def send(self, msgs):
        msgs = msgs if isinstance(msgs, (list, tuple)) else list(msgs)
        t0 = time.perf_counter()
        with self._lock:
            # lint: allow[blocking-under-lock] the mechanism: every data op runs under the switch-point mutex (§6.2) — that serialization IS LockedConn's measured cost
            self.dp.send(msgs)
        self._record_send(msgs, t0)

    def recv(self, buf, timeout=None):
        with self._lock:
            # lint: allow[blocking-under-lock] the mechanism: recv blocks under the switch-point mutex by design (§6.2); BarrierConn is the lock-free alternative
            n = self.dp.recv(buf, timeout)
        self._record_recv(buf, n)
        return n

    def reconfigure(self, new_stack, coordinate=None):
        t0 = time.perf_counter()
        with self._lock:  # switch point = lock release
            # lint: allow[blocking-under-lock] §6.2: the 2PC coordinate() callback MUST run inside the switch point — negotiation uses the connection, so the lock protects it
            if coordinate is not None and not coordinate():
                return False
            self._do_swap(new_stack)
        self.stats.last_switch_s = time.perf_counter() - t0
        if TRACER.enabled:
            TRACER.event("reconfig.blip",
                         attrs={"mechanism": "LockedConn",
                                "blip_s": self.stats.last_switch_s})
        return True


class BarrierConn(ConnHandle):
    """Lock-free fast path (§6.2): one boolean read per op; stop-the-world
    barrier only during a reconfiguration."""

    def __init__(self, stack: ConcreteStack, n_threads: int = 1):
        super().__init__(stack)
        self.n_threads = n_threads
        self._pause = False  # plain attribute read: GIL-atomic
        self._barrier = threading.Barrier(n_threads + 1)
        self._resume = threading.Event()
        self._resume.set()

    def _checkpoint(self):
        if self._pause:
            t0 = time.perf_counter()
            self._barrier.wait()
            self._resume.wait()
            self.stats.total_blocked_s += time.perf_counter() - t0

    def send(self, msgs):
        self._checkpoint()
        msgs = msgs if isinstance(msgs, (list, tuple)) else list(msgs)
        t0 = time.perf_counter()
        self.dp.send(msgs)
        self._record_send(msgs, t0)

    def recv(self, buf, timeout=None):
        self._checkpoint()
        n = self.dp.recv(buf, timeout)
        self._record_recv(buf, n)
        return n

    def reconfigure(self, new_stack, coordinate=None):
        t0 = time.perf_counter()
        self._resume.clear()
        self._pause = True
        self._barrier.wait()  # all data threads parked: the switch point
        try:
            if coordinate is not None and not coordinate():
                return False
            self._do_swap(new_stack)
            return True
        finally:
            self._pause = False
            self._barrier.reset()
            self._resume.set()
            self.stats.last_switch_s = time.perf_counter() - t0
            if TRACER.enabled:
                TRACER.event("reconfig.blip",
                             attrs={"mechanism": "BarrierConn",
                                    "blip_s": self.stats.last_switch_s})


# ---------------------------------------------------------------------------
# Multilateral two-phase commit between connection peers (§4.2)
# ---------------------------------------------------------------------------


def two_phase_commit(chan_request: Callable[[str, dict], dict], peers: List[str],
                     new_fp: str, *, timeout_s: float = 2.0,
                     epoch: Optional[int] = None,
                     on_decide: Optional[Callable[[], None]] = None) -> bool:
    """Coordinator side. chan_request(peer, msg) -> reply (reliable).

    Phase 1: all peers must accept for the transition to commit; any refusal
    or timeout aborts (a faulty peer cannot force others to switch).

    Phase 2 is presumed-commit: once every peer has voted ready the decision
    IS commit, so delivery failures must not escape the switch point and
    strand a mixed prepared/committed group — the notification loops swallow
    timeouts (the ReliableChannel already retries underneath; a peer that
    stays prepared resyncs eagerly via the epoch query, see
    ``ReconfigParticipant``). ``epoch`` (the coordinator's post-commit switch
    count) is piggybacked on the commit so peers can order it against later
    queries.

    ``on_decide`` fires exactly at the commit point — after the last ready
    vote, BEFORE any phase-2 notification. The coordinator uses it to record
    the decided epoch so that an epoch query arriving while notifications are
    still draining (they can block for seconds on an unreachable peer) is
    answered with the COMMIT decision, not the not-yet-applied local state —
    otherwise a merely-delayed peer would mistake the in-flight commit for an
    abort, clear its prepared state, and refuse the real commit when it
    lands."""
    ready = []
    sp = (TRACER.span("2pc.prepare", attrs={"fp": new_fp, "peers": list(peers)})
          if TRACER.enabled else NOOP_SPAN)
    with sp:
        for p in peers:
            try:
                r = chan_request(p, {"type": "reconfig_prepare", "fp": new_fp})
            except TimeoutError:
                r = {"type": "reconfig_refuse"}
            sp.event("vote", peer=p, vote=r.get("type"))
            if r.get("type") != "reconfig_ready":
                sp.set(status="aborted", aborted_by=p)
                for q in ready:
                    try:
                        chan_request(q, {"type": "reconfig_abort", "fp": new_fp})
                    except TimeoutError:
                        pass  # abort is also just a notification of a made decision
                return False
            ready.append(p)
    if TRACER.enabled:
        # the presumed-commit point: after the last ready vote, before any
        # phase-2 notification (the decision exists even if none land)
        TRACER.event("2pc.decide", attrs={"fp": new_fp, "epoch": epoch})
    if on_decide is not None:
        on_decide()
    commit = {"type": "reconfig_commit", "fp": new_fp}
    if epoch is not None:
        commit["epoch"] = epoch
    sp = (TRACER.span("2pc.commit", attrs={"fp": new_fp, "epoch": epoch})
          if TRACER.enabled else NOOP_SPAN)
    with sp:
        for p in peers:
            try:
                chan_request(p, commit)
                sp.event("notified", peer=p)
            except TimeoutError:
                sp.event("notify_lost", peer=p, drop_reason="timeout")
                # decision already made; see docstring
    return True


class ReconfigParticipant:
    """Peer side of the 2PC; wire into the host agent's message loop.

    2PC here is presumed-commit: once every peer voted ready the decision IS
    commit, and phase-2 notifications are best-effort. A peer that misses the
    commit (or abort) would historically stay prepared until its next
    prepare; instead, after ``resync_after_s`` of being prepared it asks the
    coordinator for the connection's current epoch + active fingerprint
    (``needs_resync`` names whom to ask; the owning ``HostAgent`` sends the
    ``reconfig_query`` and feeds the reply to ``apply_state``).

    ``epoch`` is the coordinator's switch counter: a reply with a NEWER epoch
    than we last acted on means a decision was made without us — we adopt the
    committed stack if it resolves; either way the stale prepared state is
    cleared (an equal epoch means the proposal aborted).
    """

    def __init__(self, handle: ConnHandle,
                 resolve: Callable[[str], Optional[ConcreteStack]],
                 *, resync_after_s: float = 1.0,
                 now: Callable[[], float] = time.monotonic):
        self.handle = handle
        self.resolve = resolve  # fp -> ConcreteStack we could switch to
        self.resync_after_s = resync_after_s
        self.epoch = 0  # last coordinator epoch we have acted on
        self._now = now
        self._prepared: Optional[str] = None
        self._prepared_src: Optional[str] = None
        self._prepared_at: Optional[float] = None
        self.resync_failures = 0  # epoch queries that timed out (chaos stat)

    @property
    def prepared(self) -> Optional[str]:
        """Fingerprint this peer is currently prepared for (None once the
        decision arrived or was resynced) — 'stranded' means non-None long
        after the coordinator decided."""
        return self._prepared

    def _clear_prepared(self) -> None:
        self._prepared = self._prepared_src = self._prepared_at = None

    def handle_msg(self, src: str, msg: dict) -> dict:
        t = msg.get("type")
        if t == "reconfig_prepare":
            with (TRACER.span("2pc.peer.prepare",
                              attrs={"coordinator": src, "fp": msg["fp"]})
                  if TRACER.enabled else NOOP_SPAN) as sp:
                st = self.resolve(msg["fp"])
                if st is None:
                    sp.set(vote="reconfig_refuse")
                    return {"type": "reconfig_refuse"}
                self._prepared = msg["fp"]
                self._prepared_src = src
                self._prepared_at = self._now()
                sp.set(vote="reconfig_ready")
                return {"type": "reconfig_ready"}
        if t == "reconfig_commit" and self._prepared == msg["fp"]:
            with (TRACER.span("2pc.peer.commit",
                              attrs={"coordinator": src, "fp": msg["fp"]})
                  if TRACER.enabled else NOOP_SPAN) as sp:
                st = self.resolve(msg["fp"])
                self.handle.reconfigure(st)  # nests the peer's reconfig.swap
                self.epoch = int(msg.get("epoch") or self.epoch + 1)
                self._clear_prepared()
                sp.set(epoch=self.epoch)
                return {"type": "reconfig_done"}
        if t == "reconfig_abort":
            if TRACER.enabled:
                TRACER.event("2pc.peer.abort",
                             attrs={"coordinator": src, "fp": msg.get("fp")})
            self._clear_prepared()
            return {"type": "reconfig_aborted"}
        return {"type": "reconfig_refuse"}

    # -- prepared-peer resync (epoch query) -----------------------------------
    def needs_resync(self, now: Optional[float] = None) -> Optional[str]:
        """Address of the coordinator to query, when this peer has been
        sitting prepared longer than ``resync_after_s`` (i.e. the phase-2
        notification is presumed lost); None otherwise."""
        if self._prepared is None or self._prepared_src is None:
            return None
        now = self._now() if now is None else now
        if now - self._prepared_at < self.resync_after_s:
            return None
        return self._prepared_src

    def defer_resync(self) -> None:
        """Push the next resync attempt out by a full window (called when a
        query itself timed out — don't hot-loop on an unreachable peer).
        Counted in ``resync_failures``: under a coordinator partition this
        climbs until heal, then the next window converges."""
        self.resync_failures += 1
        if self._prepared_at is not None:
            self._prepared_at = self._now()

    def apply_state(self, state: dict) -> bool:
        """Fold a ``reconfig_state`` query reply in; returns True if a missed
        commit was applied.

        A newer coordinator epoch with a resolvable fingerprint different
        from our active stack means we missed a commit: adopt it. A
        ``pending`` reply means the 2PC is still collecting votes — nothing
        is decided, so we stay prepared and re-query next window. Anything
        else (same epoch ⇒ the proposal aborted; ``reconfig_refuse`` ⇒ the
        coordinator no longer knows the connection) just clears the stale
        prepared state — the documented §4.2 failure semantics, now reached
        eagerly instead of at the next prepare."""
        if state.get("type") != "reconfig_state":
            self._clear_prepared()
            return False
        if state.get("pending"):
            self.defer_resync()  # decision in flight: wait, don't conclude
            return False
        fp = state.get("fp")
        epoch = int(state.get("epoch") or 0)
        applied = False
        if epoch > self.epoch and fp:
            st = self.resolve(fp)
            if st is not None and self.handle.stack.fingerprint() != fp:
                applied = bool(self.handle.reconfigure(st))
            self.epoch = epoch
        if TRACER.enabled:
            TRACER.event("2pc.resync",
                         attrs={"fp": fp, "epoch": epoch, "applied": applied})
        self._clear_prepared()
        return applied
