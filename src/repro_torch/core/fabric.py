"""In-process host fabric: the 'network' under host-level chunnels.

Best-effort datagram delivery between named endpoints with configurable
latency and loss (so the negotiation protocol's reliability layer is exercised
for real). Used by the §7-style application benchmarks and the negotiation /
reconfiguration protocols; the tensor math itself rides the JAX mesh.

The data path is batched (docs/architecture.md §8): ``Fabric.send_batch``
moves a whole list of messages with one registration-table read, one RNG
acquisition (loss applied per message via a precomputed Bernoulli mask, one
jitter draw per batch), one byte-accounting update and one delivery timer.
``Endpoint`` inboxes are bounded ring buffers (deque + condition variable);
``recv_many`` drains everything available under a single wakeup. The fabric
registration lock guards only register/unregister/set_link — never delivery.
"""
from __future__ import annotations

import queue
import random
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.obs.trace import TRACER


@dataclass
class LinkModel:
    latency_s: float = 0.0
    jitter_s: float = 0.0
    loss: float = 0.0  # probability a datagram is dropped


@dataclass
class FabricCounters:
    """Split datagram accounting (msgs + bytes). ``sent`` counts everything
    offered to the fabric; a sent datagram is then exactly one of delivered /
    dropped_loss / dropped_unroutable / dropped_overflow (or still in flight
    on a latency timer). Plain ints riding the GIL — advisory, like telemetry."""

    sent: int = 0
    delivered: int = 0
    dropped_loss: int = 0
    dropped_unroutable: int = 0
    dropped_overflow: int = 0  # receiver ring full
    sent_bytes: int = 0
    delivered_bytes: int = 0

    def snapshot(self) -> dict:
        return {
            "sent": self.sent,
            "delivered": self.delivered,
            "dropped_loss": self.dropped_loss,
            "dropped_unroutable": self.dropped_unroutable,
            "dropped_overflow": self.dropped_overflow,
            "sent_bytes": self.sent_bytes,
            "delivered_bytes": self.delivered_bytes,
        }


class Endpoint:
    """A named fabric endpoint with a bounded ring-buffer inbox.

    The ring is a deque guarded by one condition variable; a batch delivery
    appends every message and signals waiters once, so per-message cost on
    the hot path is a single ``deque.append``."""

    def __init__(self, addr: str, fabric: "Fabric", *, capacity: int = 65536):
        self.addr = addr
        self.fabric = fabric
        self.capacity = capacity
        self._ring: deque = deque()
        self._cv = threading.Condition()

    # -- sending ---------------------------------------------------------------
    def send(self, dst: str, msg: Any) -> None:
        self.fabric.send_batch(self.addr, dst, (msg,))

    def send_batch(self, dst: str, msgs: Sequence[Any]) -> int:
        """Vectorized send; returns the number of messages accepted for
        delivery (i.e. not lost / unroutable)."""
        return self.fabric.send_batch(self.addr, dst, msgs)

    # -- receiving -------------------------------------------------------------
    def recv(self, timeout: Optional[float] = None) -> Optional[Tuple[str, Any]]:
        buf: List[Any] = [None]
        n = self.recv_many(buf, timeout=timeout)
        return buf[0] if n else None

    def recv_many(self, buf: list, max_n: Optional[int] = None,
                  timeout: Optional[float] = None) -> int:
        """Drain up to ``min(len(buf), max_n)`` queued ``(src, msg)`` pairs
        into ``buf`` under one condition acquisition. Blocks up to ``timeout``
        for the first message only — it never waits for a full buffer."""
        want = len(buf) if max_n is None else min(max_n, len(buf))
        if want <= 0:
            return 0
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            while not self._ring:
                if deadline is None:
                    self._cv.wait()
                else:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return 0
                    self._cv.wait(remaining)
            avail = len(self._ring)
            if want >= avail:
                buf[:avail] = self._ring  # bulk drain, C-level iteration
                self._ring.clear()
                n = avail
            else:
                pop = self._ring.popleft
                for i in range(want):
                    buf[i] = pop()
                n = want
        # Record only short reads (outside the ring lock): a full read is the
        # steady state and already visible from the sender's record — skipping
        # it keeps the enabled-tracing cost at one record per round trip
        # (bench_overhead gates <10% at batch=64). A short read marks the tail
        # of a burst (or starvation), which is the receiver-side event worth a
        # timeline instant.
        if n < want and TRACER.enabled:
            TRACER.record_batch("fabric.recv_many", n, n)
        return n

    def _deliver_batch(self, items: Sequence[Tuple[str, Any]]) -> int:
        """Fabric-side delivery: append a batch, notify waiters once. Returns
        how many messages fit in the ring (the rest are overflow-dropped)."""
        with self._cv:
            space = self.capacity - len(self._ring)
            if space <= 0:
                return 0
            accepted = min(space, len(items))
            self._ring.extend(items if accepted == len(items) else items[:accepted])
            self._cv.notify_all()
            return accepted

    def pending(self) -> int:
        with self._cv:
            return len(self._ring)

    def close(self) -> None:
        self.fabric.unregister(self.addr)


class Fabric:
    def __init__(self, *, default_link: LinkModel | None = None, seed: int = 0,
                 endpoint_capacity: int = 65536):
        self._eps: Dict[str, Endpoint] = {}
        self._links: Dict[Tuple[str, str], LinkModel] = {}
        self._default = default_link or LinkModel()
        self._capacity = endpoint_capacity
        self._rng = random.Random(seed)
        # registration lock: register/unregister/set_link only (control plane)
        self._lock = threading.Lock()
        # small data-plane lock serializing the shared RNG; held once per batch
        self._rng_lock = threading.Lock()
        self._register_hooks: List[Callable[[str], None]] = []
        self.counters = FabricCounters()

    # -- control plane (registration lock) --------------------------------------
    def register(self, addr: str) -> Endpoint:
        with self._lock:
            if addr in self._eps:
                raise ValueError(f"address in use: {addr}")
            ep = Endpoint(addr, self, capacity=self._capacity)
            self._eps[addr] = ep
            hooks = tuple(self._register_hooks)
        for cb in hooks:  # outside the lock: hooks may call set_link etc.
            cb(addr)
        return ep

    def unregister(self, addr: str) -> None:
        with self._lock:
            self._eps.pop(addr, None)

    def set_link(self, src: str, dst: str, model: LinkModel) -> None:
        with self._lock:
            self._links[(src, dst)] = model

    def clear_link(self, src: str, dst: str) -> None:
        """Remove a per-pair override so the pair reverts to the default link."""
        with self._lock:
            self._links.pop((src, dst), None)

    def get_link(self, src: str, dst: str) -> LinkModel:
        """Effective link model for a pair (override if set, else default)."""
        with self._lock:
            return self._links.get((src, dst), self._default)

    def link_override(self, src: str, dst: str) -> Optional[LinkModel]:
        """The per-pair override, or None if the pair rides the default link.
        Fault injectors use this to save/restore state across heal events."""
        with self._lock:
            return self._links.get((src, dst))

    def endpoints(self) -> List[str]:
        """Snapshot of registered endpoint addresses (control plane only)."""
        with self._lock:
            return list(self._eps)

    def add_register_hook(self, cb: Callable[[str], None]) -> None:
        """Observe endpoint registration (chaos injection, service discovery).
        Hooks run after the endpoint is routable, outside the fabric lock."""
        with self._lock:
            self._register_hooks.append(cb)

    def remove_register_hook(self, cb: Callable[[str], None]) -> None:
        with self._lock:
            try:
                self._register_hooks.remove(cb)
            except ValueError:
                pass

    # -- data plane (no registration lock) ---------------------------------------
    def send(self, src: str, dst: str, msg: Any) -> None:
        self.send_batch(src, dst, (msg,))

    def send_batch(self, src: str, dst: str, msgs: Sequence[Any]) -> int:
        """The batched hot path: one link lookup, one RNG acquisition (loss
        applied via a per-message Bernoulli mask, one jitter draw), one byte
        accounting update and one delivery (timer) per batch. Returns the
        number of messages accepted for delivery."""
        if not isinstance(msgs, (list, tuple)):
            msgs = list(msgs)
        if not msgs:
            return 0
        # dict reads ride the GIL; _links/_eps are only mutated under _lock
        m = self._links.get((src, dst), self._default)
        ep = self._eps.get(dst)
        # not under any lock; inline len() for the common bytes payload
        sizes = [len(x) if type(x) is bytes else _approx_size(x) for x in msgs]
        c = self.counters
        with self._rng_lock:
            # shared Random() under a lock: an unguarded draw can repeat/skip
            # states under contention
            rng = self._rng.random
            jitter = rng() if m.jitter_s else 0.0
            mask = [rng() >= m.loss for _ in msgs] if m.loss else None
        c.sent += len(msgs)
        c.sent_bytes += sum(sizes)
        if ep is None:
            c.dropped_unroutable += len(msgs)
            if TRACER.enabled:  # dropped batches close with a drop_reason
                TRACER.record_batch("fabric.send_batch", len(msgs), 0,
                                    {"dst": dst, "drop_reason": "unroutable"})
            return 0
        if mask is None:
            kept = msgs  # not mutated downstream: items/sizes are derived views
            kept_sizes = sizes
        else:
            kept = [x for x, keep in zip(msgs, mask) if keep]
            kept_sizes = [s for s, keep in zip(sizes, mask) if keep]
            c.dropped_loss += len(msgs) - len(kept)
        if TRACER.enabled:  # one tuple per batch, never per message (§10)
            TRACER.record_batch(
                "fabric.send_batch", len(msgs), len(kept),
                {"drop_reason": "loss"} if len(kept) < len(msgs) else None)
        if not kept:
            return 0
        items = [(src, x) for x in kept]
        delay = m.latency_s + jitter * m.jitter_s
        if delay > 0:
            t = threading.Timer(delay, self._deliver, args=(ep, items, kept_sizes))
            t.daemon = True
            t.start()
        else:
            self._deliver(ep, items, kept_sizes)
        return len(kept)

    def _deliver(self, ep: Endpoint, items: List[Tuple[str, Any]],
                 sizes: List[int]) -> None:
        accepted = ep._deliver_batch(items)
        c = self.counters
        c.delivered += accepted
        c.dropped_overflow += len(items) - accepted
        c.delivered_bytes += sum(sizes) if accepted == len(items) else sum(sizes[:accepted])
        if accepted < len(items) and TRACER.enabled:
            TRACER.record_batch("fabric.deliver", len(items), accepted,
                                {"dst": ep.addr, "drop_reason": "overflow"})


def approx_size(msg: Any) -> int:
    """Rough wire size of a fabric message — used for accounting (fabric
    byte counters, connection telemetry), not for framing."""
    return _approx_size(msg)


def _approx_size(msg: Any) -> int:
    if isinstance(msg, (bytes, bytearray)):
        return len(msg)
    if isinstance(msg, str):
        return len(msg)
    if isinstance(msg, dict):
        return sum(_approx_size(k) + _approx_size(v) for k, v in msg.items())
    if isinstance(msg, (list, tuple)):
        return sum(_approx_size(v) for v in msg)
    nbytes = getattr(msg, "nbytes", None)  # numpy/JAX arrays
    if isinstance(nbytes, int):
        return nbytes
    return 8


import itertools

# Sequence numbers are process-global and monotonic so a fresh channel between
# the same endpoints can never collide with the receiver's dedupe window.
_GLOBAL_SEQ = itertools.count(1)
_GLOBAL_SEQ_LOCK = threading.Lock()


def _next_seq() -> int:
    with _GLOBAL_SEQ_LOCK:
        return next(_GLOBAL_SEQ)


class ReliableChannel:
    """Reliability + ordering over the best-effort fabric — Bertha §5.1: 'a
    simple reliability and ordering protocol ... used for negotiation'.
    Application chunnels bring their own reliability.

    ``request`` is the classic stop-and-wait RPC. ``request_window`` pipelines
    up to ``window`` frames before blocking on acks (go-back-N retransmit,
    cumulative ``_cum`` acks), so multi-frame flows to one peer stop paying a
    full RTT per frame. The receiver (``serve_one``) processes window frames
    in order, holding out-of-order arrivals, and answers retransmissions of
    already-processed frames from a per-window reply cache — the handler
    still observes exactly-once semantics."""

    def __init__(self, ep: Endpoint, peer: str, *, timeout: float = 0.05,
                 retries: int = 40, window: int = 8,
                 reply_cache_size: int = 64, max_windows: int = 32):
        self.ep = ep
        self.peer = peer
        self.timeout = timeout
        self.retries = retries
        self.window = window
        self.reply_cache_size = reply_cache_size
        self.max_windows = max_windows
        self._rx_seq: Dict[str, int] = {}
        self._reply_cache: Dict[Tuple[str, int], Any] = {}
        # per-peer insertion order: seqs are process-global (sparse per peer),
        # so eviction must go by arrival order, not by seq arithmetic
        self._reply_order: Dict[str, deque] = {}
        self._win_rx: Dict[Tuple[str, int], dict] = {}
        self._win_order: deque = deque()
        self._pending: "queue.Queue[Tuple[str, Any]]" = queue.Queue()
        # advisory counters (plain ints riding the GIL, like FabricCounters):
        # frames sent a 2nd+ time, and duplicate frames answered from cache
        self.retransmits = 0
        self.dup_replies = 0

    # -- client side -------------------------------------------------------------
    def request(self, msg: Any, *, retries: Optional[int] = None) -> Any:
        """Send reliably and wait for the (piggybacked) reply. ``retries``
        overrides the channel default for this call (fail-fast probes)."""
        seq = _next_seq()
        frame = {"_seq": seq, "body": msg}
        # The frame dict is built ONCE: a retransmission reuses the same
        # "_tc", so the wire span id is stable across retries by design.
        sp = TRACER.begin_span("rc.request",
                               attrs={"peer": self.peer, "seq": seq})
        if sp:
            frame["_tc"] = sp.ctx
        n_tries = self.retries if retries is None else retries
        for attempt in range(n_tries):
            if attempt:
                self.retransmits += 1
                sp.event("retransmit", retry=attempt)
            self.ep.send(self.peer, frame)
            deadline = time.monotonic() + self.timeout
            while True:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                got = self.ep.recv(timeout=remaining)
                if got is None:
                    break
                src, m = got
                if isinstance(m, dict) and m.get("_ack") == seq and src == self.peer:
                    sp.end()
                    return m["body"]
                self._pending.put((src, m))
        sp.end(status="timeout", drop_reason="no_reply", retries=n_tries)
        raise TimeoutError(f"no reply from {self.peer} after {n_tries} retries")

    def request_window(self, msgs: Sequence[Any], *,
                       window: Optional[int] = None) -> List[Any]:
        """Pipelined reliable request: up to W frames in flight before
        blocking on acks. Returns the replies in request order. Raises
        TimeoutError after ``retries`` consecutive no-progress rounds."""
        msgs = list(msgs)
        n = len(msgs)
        if n == 0:
            return []
        W = max(1, self.window if window is None else window)
        win_id = _next_seq()
        frames = [{"_seq": _next_seq(), "_win": (win_id, i, n), "body": b}
                  for i, b in enumerate(msgs)]
        # One span for the whole window; every frame carries the same
        # "_tc" and the dicts are reused on go-back-N resends, so a
        # retransmitted frame keeps its original span id (tagged retry=n
        # below) instead of minting a new identity per attempt.
        sp = TRACER.begin_span("rc.window",
                               attrs={"peer": self.peer, "n": n, "win": win_id})
        if sp:
            tc = sp.ctx
            for f in frames:
                f["_tc"] = tc
        seq2idx = {f["_seq"]: i for i, f in enumerate(frames)}
        replies: List[Any] = [None] * n
        acked = [False] * n
        sent = [0] * n  # per-frame send counts (retry=sent[i] on resend)
        base = 0
        stalls = 0
        while True:
            while base < n and acked[base]:
                base += 1
            if base >= n:
                sp.end()
                return replies
            hi = min(base + W, n)
            # go-back-N: (re)send every unacked frame in the window as a batch
            resend = [i for i in range(base, hi) if not acked[i]]
            for i in resend:
                if sent[i]:
                    self.retransmits += 1
                    sp.event("retransmit", frame=i, retry=sent[i])
                sent[i] += 1
            self.ep.send_batch(self.peer, [frames[i] for i in resend])
            deadline = time.monotonic() + self.timeout
            progress = False
            while True:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                got = self.ep.recv(timeout=remaining)
                if got is None:
                    break
                src, m = got
                if (src == self.peer and isinstance(m, dict)
                        and m.get("_ack") in seq2idx):
                    i = seq2idx[m["_ack"]]
                    if not acked[i]:
                        acked[i] = True
                        replies[i] = m["body"]
                        progress = True
                    if all(acked[base:min(base + W, n)]):
                        break  # window fully acked: slide + refill immediately
                else:
                    self._pending.put(got)
            if progress:
                stalls = 0
            else:
                stalls += 1
                if stalls >= self.retries:
                    sp.end(status="timeout", drop_reason="window_stalled",
                           acked=sum(acked))
                    raise TimeoutError(
                        f"window to {self.peer} stalled after {self.retries} retries")

    # -- server side -------------------------------------------------------------
    def serve_one(self, handler: Callable[[str, Any], Any],
                  timeout: Optional[float] = None) -> bool:
        """Receive one reliable frame, dedupe, reply via handler."""
        got = None
        try:
            got = self._pending.get_nowait()
        except queue.Empty:
            got = self.ep.recv(timeout=timeout)
        if got is None:
            return False
        src, m = got
        if not (isinstance(m, dict) and "_seq" in m):
            return False
        if "_win" in m:
            return self._serve_window(src, m, handler)
        seq = m["_seq"]
        last = self._rx_seq.get(src, 0)
        if seq > last:
            tc = m.get("_tc") if TRACER.enabled else None
            if tc is not None:
                # re-parent the handler's spans under the sender's span so
                # one trace stitches across endpoints
                with TRACER.adopt(tc):
                    reply = handler(src, m["body"])
            else:
                reply = handler(src, m["body"])
            self._cache_reply(src, seq, reply)
        else:
            # Retransmission (our ack was lost): resend the cached reply so the
            # handler observes exactly-once semantics.
            reply = self._reply_cache.get((src, seq))
            self.dup_replies += 1
        self._rx_seq[src] = max(last, seq)
        self.ep.send(src, {"_ack": seq, "body": reply})
        return True

    def _cache_reply(self, src: str, seq: int, reply: Any) -> None:
        self._reply_cache[(src, seq)] = reply
        order = self._reply_order.setdefault(src, deque())
        order.append(seq)
        while len(order) > self.reply_cache_size:
            self._reply_cache.pop((src, order.popleft()), None)

    def _serve_window(self, src: str, m: dict, handler) -> bool:
        win_id, idx, _n = m["_win"]
        key = (src, win_id)
        st = self._win_rx.get(key)
        if st is None:
            st = {"next": 0, "held": {}, "replies": {}}
            self._win_rx[key] = st
            self._win_order.append(key)
            while len(self._win_order) > self.max_windows:
                self._win_rx.pop(self._win_order.popleft(), None)
        if idx < st["next"]:
            # retransmission of a processed frame: cached reply, handler not re-run
            self.dup_replies += 1
            self.ep.send(src, {"_ack": m["_seq"], "_cum": st["next"] - 1,
                               "body": st["replies"].get(idx)})
            return True
        st["held"][idx] = m
        acks = []
        while st["next"] in st["held"]:
            f = st["held"].pop(st["next"])
            tc = f.get("_tc") if TRACER.enabled else None
            if tc is not None:
                with TRACER.adopt(tc):
                    reply = handler(src, f["body"])
            else:
                reply = handler(src, f["body"])
            st["replies"][st["next"]] = reply
            acks.append({"_ack": f["_seq"], "body": reply})
            st["next"] += 1
        if acks:
            cum = st["next"] - 1
            for a in acks:
                a["_cum"] = cum
            self.ep.send_batch(src, acks)
        return True
