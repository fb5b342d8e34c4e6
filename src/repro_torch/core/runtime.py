"""Host agents: the Bertha runtime gluing fabric + negotiation + reconfiguration.

A HostAgent owns a fabric endpoint and a listener thread. Servers register a
Stack; clients ``connect(addr, stack)`` which negotiates (§5) and returns a
reconfigurable ConnHandle (§4). In the training framework each participating
host runs one agent; negotiation guarantees every host compiles the *same*
step-function stack — the SPMD-safety property that makes Bertha's
compatibility checking load-bearing on a TPU cluster.
"""
from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, List, Optional

from repro_torch.core.chunnel import Chunnel, Datapath, WireType
from repro_torch.core.fabric import Endpoint, Fabric, ReliableChannel
from repro_torch.core.negotiate import (
    NegotiatedConn,
    NegotiationError,
    ServerNegotiator,
    ZeroRttCache,
    client_negotiate,
)
from repro_torch.core.reconfigure import BarrierConn, ConnHandle, LockedConn, ReconfigParticipant
from repro_torch.core.stack import ConcreteStack, Stack
from repro_torch.obs.trace import TRACER

BYTES = WireType.of("bytes")

#: consecutive failed epoch queries before the flight-recorder strand alarm
_STRAND_ALARM_FAILURES = 3


class FabricTransport(Chunnel):
    """Bottom-of-stack transport over the host fabric (bootstraps from unit
    type, like the paper's KernelUdpChunnel)."""

    upper_type = BYTES
    lower_type = WireType.of("unit")

    def __init__(self, ep: Endpoint, peer: str, label: str = "FabricTransport"):
        self.ep = ep
        self.peer = peer
        self._label = label

    @property
    def name(self) -> str:
        return self._label

    def connect_wrap(self, inner: Optional[Datapath]) -> Datapath:
        assert inner is None, "transport chunnels bootstrap from the unit type"
        return _FabricDatapath(self.ep, self.peer)


class _FabricDatapath(Datapath):
    def __init__(self, ep: Endpoint, peer: str):
        self.ep = ep
        self.peer = peer

    def send(self, msgs: Iterable[Any]) -> None:
        frames = [{"_data": m} for m in msgs]
        if frames:
            self.ep.send_batch(self.peer, frames)

    def recv(self, buf: list, timeout: Optional[float] = None) -> int:
        n = 0
        tmp: list = [None] * len(buf)
        deadline = None if timeout is None else time.monotonic() + timeout
        while n < len(buf):
            t = None if deadline is None else max(0.0, deadline - time.monotonic())
            got = self.ep.recv_many(tmp, max_n=len(buf) - n, timeout=t)
            if not got:
                break
            for k in range(got):  # unwrap frames (non-data frames are skipped)
                m = tmp[k][1]
                if isinstance(m, dict) and "_data" in m:
                    buf[n] = m["_data"]
                    n += 1
            if n:
                deadline = time.monotonic()  # drain whatever is queued
        return n


class HostAgent:
    """One Bertha runtime endpoint: fabric address + listener thread +
    negotiation/reconfiguration state.

    Servers call ``listen(stack)``; clients call ``connect(addr, stack)`` and
    get back a reconfigurable ``ConnHandle``. Multilateral switches go
    through ``reconfigure_multilateral`` (2PC); peers participate via
    ``register_participant``. The listener loop also pumps the prepared-peer
    resync: any participant stuck prepared past its resync window gets its
    coordinator queried for the connection's current epoch + stack (a
    dedicated ``<addr>/resync`` endpoint carries the query so it cannot steal
    frames from in-flight negotiations on the main endpoint)."""

    def __init__(self, fabric: Fabric, addr: str, *, mechanism: str = "lock",
                 n_data_threads: int = 1):
        self.fabric = fabric
        self.addr = addr
        self.ep = fabric.register(addr)
        self.ctrl = fabric.register(addr + "/ctrl")
        self._resync_ep = fabric.register(addr + "/resync")
        self.mechanism = mechanism
        self.n_data_threads = n_data_threads
        self.zero_rtt = ZeroRttCache()
        self._negotiator: Optional[ServerNegotiator] = None
        self._participants: Dict[str, ReconfigParticipant] = {}
        self._coordinating: Dict[str, ConnHandle] = {}
        self._decided: Dict[str, tuple] = {}  # conn -> (epoch, fp) at commit point
        self._pending: Dict[str, str] = {}    # conn -> fp of an undecided 2PC
        self._handlers: Dict[str, Callable[[str, dict], dict]] = {}
        self._chans: Dict[str, ReliableChannel] = {}  # per-peer client channels
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    # -- server side -----------------------------------------------------------
    def listen(self, stack: Stack) -> ServerNegotiator:
        self._negotiator = ServerNegotiator(stack)
        return self._negotiator

    def on(self, msg_type: str, handler: Callable[[str, dict], dict]) -> None:
        self._handlers[msg_type] = handler

    def _dispatch(self, src: str, body: dict) -> dict:
        t = body.get("type", "")
        if t in ("offer", "zero_rtt"):
            if self._negotiator is None:
                return {"type": "reject", "reason": "not listening"}
            return self._negotiator.handle(src, body)
        if t == "reconfig_query":
            # Prepared-peer resync: report the connection's current epoch
            # (switch count) + active stack fingerprint. A coordinator answers
            # from the handle it drove through the 2PC; a fellow peer answers
            # from its own committed knowledge (its epoch orders the same way).
            conn = body.get("conn", "")
            h = self._coordinating.get(conn)
            if h is not None:
                epoch, fp = h.stats.switches, h.stack.fingerprint()
                dec = self._decided.get(conn)
                if dec is not None and dec[0] > epoch:
                    # commit decided but the local swap has not applied yet
                    # (phase-2 notifications still draining): answer with the
                    # DECISION, or a delayed peer reads "aborted" and later
                    # refuses the real commit (permanent divergence)
                    epoch, fp = dec
                elif conn in self._pending:
                    # phase 1 still collecting votes: nothing is decided, so a
                    # prepared peer must WAIT, not conclude "aborted" from the
                    # unchanged epoch (a slow co-peer's prepare can outlast a
                    # fast peer's resync window)
                    return {"type": "reconfig_state", "conn": conn,
                            "epoch": epoch, "fp": fp, "pending": True}
                return {"type": "reconfig_state", "conn": conn,
                        "epoch": epoch, "fp": fp}
            part = self._participants.get(conn)
            if part is not None:
                return {"type": "reconfig_state", "conn": conn,
                        "epoch": part.epoch,
                        "fp": part.handle.stack.fingerprint()}
            return {"type": "reconfig_refuse", "reason": f"unknown conn {conn!r}"}
        if t.startswith("reconfig_"):
            # Strict conn-id dispatch: an unknown id must be refused, never
            # routed to an arbitrary participant — a reconfig_prepare/commit
            # for conn B must not prepare or swap conn A's stack.
            conn = body.get("conn", "")
            part = self._participants.get(conn)
            if part is None:
                return {"type": "reconfig_refuse", "reason": f"unknown conn {conn!r}"}
            return part.handle_msg(src, body)
        h = self._handlers.get(t)
        if h is not None:
            return h(src, body)
        return {"type": "error", "reason": f"no handler for {t!r}"}

    def _loop(self) -> None:
        chan = ReliableChannel(self.ctrl, peer="*")
        while not self._stop.is_set():
            chan.serve_one(self._dispatch, timeout=0.05)
            self._resync_prepared()

    def _resync_prepared(self) -> None:
        """Eagerly resolve peers stuck in the prepared state: query each
        overdue participant's coordinator for the current epoch/stack and
        fold the answer in (commit the missed decision or clear the stale
        prepared flag). Runs on the listener thread; query timeouts defer the
        participant to its next window instead of blocking the loop."""
        for conn_id, part in list(self._participants.items()):
            src = part.needs_resync()
            if src is None:
                continue
            chan = ReliableChannel(self._resync_ep, src + "/ctrl",
                                   timeout=0.05, retries=4)
            try:
                reply = chan.request({"type": "reconfig_query", "conn": conn_id})
            except TimeoutError:
                part.defer_resync()
                # Stranded-peer alarm: a prepared participant whose epoch
                # queries keep timing out cannot learn the 2PC verdict.
                # Dump the flight recorder once per conn (no-op when
                # tracing is disabled) so the spans leading up to the
                # strand survive for python -m repro.obs to render.
                if part.resync_failures == _STRAND_ALARM_FAILURES and TRACER.enabled:
                    from repro_torch.obs.flight import strand_alarm
                    strand_alarm(conn_id, src, part.resync_failures)
                continue
            part.apply_state(reply if isinstance(reply, dict) else {})

    # -- client side -----------------------------------------------------------
    def connect(self, peer: str, stack: Stack, *, use_zero_rtt: bool = False) -> ConnHandle:
        chan = ReliableChannel(self.ep, peer + "/ctrl")
        neg = client_negotiate(chan, stack, self.zero_rtt if use_zero_rtt else None)
        handle = self._make_handle(neg.stack)
        handle.nonce = neg.nonce
        handle.was_zero_rtt = neg.zero_rtt
        handle.source_stack = stack
        return handle

    def accept_stack(self, peer: str) -> Optional[ConcreteStack]:
        if self._negotiator is None:
            return None
        return self._negotiator.negotiated.get(peer)

    def _make_handle(self, concrete: ConcreteStack) -> ConnHandle:
        if self.mechanism == "barrier":
            return BarrierConn(concrete, n_threads=self.n_data_threads)
        return LockedConn(concrete)

    def register_participant(self, conn_id: str, handle: ConnHandle,
                             resolve: Callable[[str], Optional[ConcreteStack]],
                             *, resync_after_s: float = 1.0) -> None:
        """Make this agent a 2PC participant for ``conn_id``: prepares/commits
        arriving for that connection drive ``handle``; ``resolve`` maps a
        proposed fingerprint to a ConcreteStack we could switch to (None ⇒
        refuse). ``resync_after_s`` bounds how long the peer may sit prepared
        before the epoch-query resync kicks in."""
        self._participants[conn_id] = ReconfigParticipant(
            handle, resolve, resync_after_s=resync_after_s)

    def participant(self, conn_id: str) -> Optional[ReconfigParticipant]:
        """The registered participant for ``conn_id`` (chaos scenarios assert
        on its ``prepared``/``epoch``/``resync_failures`` state)."""
        return self._participants.get(conn_id)

    def coordinate(self, conn_id: str, handle: ConnHandle) -> None:
        """Record this agent as ``conn_id``'s 2PC coordinator so it can
        answer peers' ``reconfig_query`` resyncs from ``handle``'s live state
        (epoch = switch count, fp = active stack).
        ``reconfigure_multilateral`` calls this automatically."""
        self._coordinating[conn_id] = handle

    def record_decision(self, conn_id: str, epoch: int, fp: str) -> None:
        """Record a 2PC commit DECISION for ``conn_id`` (fired by
        ``two_phase_commit``'s on_decide hook, at the commit point, before
        phase-2 notifications). Epoch queries arriving while notifications
        drain — or before the local swap applies — are answered from this
        record instead of the stale pre-swap handle state."""
        self._decided[conn_id] = (epoch, fp)

    def _chan(self, peer: str, timeout: float, retries: int) -> ReliableChannel:
        """Cached per-peer client channel on the main endpoint (keeps the
        receiver's window/dedupe state warm across calls)."""
        ch = self._chans.get(peer)
        if ch is None or ch.timeout != timeout or ch.retries != retries:
            ch = ReliableChannel(self.ep, peer, timeout=timeout, retries=retries)
            self._chans[peer] = ch
        return ch

    def request(self, peer: str, msg: dict, *, timeout: float = 0.1, retries: int = 40) -> dict:
        return self._chan(peer + "/ctrl", timeout, retries).request(msg)

    def request_many(self, peer: str, msgs: List[dict], *, timeout: float = 0.1,
                     retries: int = 40, window: Optional[int] = None) -> List[dict]:
        """Pipelined reliable requests to one peer: up to W frames in flight
        (ReliableChannel.request_window) instead of one RTT per frame."""
        return self._chan(peer + "/ctrl", timeout, retries).request_window(
            msgs, window=window)

    def reconfigure_multilateral(self, handle: ConnHandle, new_stack: ConcreteStack,
                                 peers: List[str], conn_id: str, *,
                                 timeout: float = 0.1,
                                 retries: int = 40) -> bool:
        """Switch a multilateral stack across all endpoints of ``conn_id``.

        Runs the two-phase commit with ``peers`` *inside* ``handle``'s switch
        point (§4.2: negotiation happens while the lock/barrier is held, so
        no data thread can race the group decision), then swaps locally.

        Args:
            handle: this side's live connection (LockedConn/BarrierConn).
            new_stack: the agreed target — must resolve on every peer (each
                participant's ``resolve`` refuses unknown fingerprints, which
                aborts the 2PC).
            peers: fabric addresses of the other endpoints.
            conn_id: the connection's group identity; peers registered it via
                ``register_participant``.
            timeout/retries: per-request reliability budget. The defaults
                tolerate seconds of peer unreachability; chaos scenarios pass
                a small budget so a coordinator crashed mid-commit releases
                the switch point quickly (phase-2 stays presumed-commit
                either way).

        Returns:
            True if all peers voted ready and the swap committed; False if
            any peer refused/timed out (everyone keeps the old stack). Once
            committed, phase-2 delivery is best-effort: a peer that misses
            the notification resyncs eagerly through the epoch query this
            agent answers as coordinator (see ``coordinate``).
        """
        from repro_torch.core.reconfigure import two_phase_commit

        self.coordinate(conn_id, handle)
        epoch = handle.stats.switches + 1  # our count once this commits
        fp = new_stack.fingerprint()

        def coordinate() -> bool:
            return two_phase_commit(
                lambda p, m: self.request(p, {**m, "conn": conn_id},
                                          timeout=timeout, retries=retries),
                peers, fp, epoch=epoch,
                on_decide=lambda: self.record_decision(conn_id, epoch, fp),
            )

        self._pending[conn_id] = fp  # queries during phase 1 answer "pending"
        try:
            return handle.reconfigure(new_stack, coordinate=coordinate)
        finally:
            self._pending.pop(conn_id, None)

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=1.0)
        self.ep.close()
        self.ctrl.close()
        self._resync_ep.close()
