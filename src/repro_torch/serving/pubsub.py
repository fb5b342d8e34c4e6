"""In-process pub/sub services with contrasting latency/ordering/cost models
(paper §7.2): the substrate under the pub/sub chunnel Select.

  KafkaBroker   self-hosted: low per-message latency, always ordered,
                fixed hourly cost, capacity-limited (queueing above rate).
  CloudPubSub   managed: higher base latency, per-message cost, elastic.
  SQSBroker     managed: ordered OR best-effort mode (cheaper + faster
                unordered — receive-side ordering then becomes the client's
                job, the Fig. 5 reconfiguration).
"""
from __future__ import annotations

import heapq
import itertools
import random
import threading
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from repro_torch.core.capability import CapabilitySet
from repro_torch.core.chunnel import Chunnel, Datapath, WireType

MSG = WireType.of("pubsub-msg")


@dataclass
class BrokerModel:
    name: str
    base_latency_s: float
    per_msg_cost: float  # $ per message
    fixed_cost_per_h: float  # $ per hour (self-hosted)
    ordered: bool
    capacity_mps: float = 1e9  # messages/sec before queueing
    jitter_s: float = 0.0


KAFKA = BrokerModel("kafka", base_latency_s=0.0006, per_msg_cost=0.0,
                    fixed_cost_per_h=1.50, ordered=True, capacity_mps=50_000)
GCP_PUBSUB = BrokerModel("gcp-pubsub", base_latency_s=0.004, per_msg_cost=4e-8,
                         fixed_cost_per_h=0.0, ordered=True, jitter_s=0.002)
SQS_ORDERED = BrokerModel("sqs-fifo", base_latency_s=0.006, per_msg_cost=5e-7,
                          fixed_cost_per_h=0.0, ordered=True, jitter_s=0.002)
SQS_BEST_EFFORT = BrokerModel("sqs", base_latency_s=0.0022, per_msg_cost=4e-7,
                              fixed_cost_per_h=0.0, ordered=False, jitter_s=0.0015)


class Broker:
    """Topic-based broker honoring a BrokerModel."""

    def __init__(self, model: BrokerModel, seed: int = 0):
        self.model = model
        self._subs: Dict[str, List[Callable[[dict], None]]] = defaultdict(list)
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self._last_deliver: Dict[str, float] = defaultdict(float)
        self.published = 0
        self.cost = 0.0
        self._seq = itertools.count()

    def subscribe(self, topic: str, fn: Callable[[dict], None]) -> None:
        with self._lock:
            self._subs[topic].append(fn)

    def unsubscribe_all(self, topic: str) -> None:
        with self._lock:
            self._subs[topic] = []

    def n_subscribers(self, topic: str) -> int:
        return len(self._subs[topic])

    def publish(self, topic: str, msg: dict) -> None:
        self.publish_batch(topic, (msg,))

    def publish_batch(self, topic: str, msgs) -> None:
        """Batched publish: one lock acquisition and one shared latency draw
        for the whole batch; per-message capacity spacing and (for unordered
        models) per-message reorder jitter are preserved. Messages without
        reorder jitter deliver together when the batch clears the capacity
        pipe — for a single message this matches the per-message model
        exactly."""
        msgs = list(msgs)
        if not msgs:
            return
        m = self.model
        now = time.monotonic()
        with self._lock:
            self.published += len(msgs)
            self.cost += m.per_msg_cost * len(msgs)
            seqs = [next(self._seq) for _ in msgs]
            delay = m.base_latency_s + (self._rng.random() * m.jitter_s)
            # capacity queueing: deliveries serialize at 1/capacity spacing;
            # the batch occupies len(msgs) slots in the pipe
            earliest = max(now + delay,
                           self._last_deliver[topic] + 1.0 / m.capacity_mps)
            done = earliest + (len(msgs) - 1) / m.capacity_mps
            self._last_deliver[topic] = done
            subs = list(self._subs[topic])
            # best-effort: occasional per-message reorder via extra delay
            extra = [m.base_latency_s * self._rng.random() * 2
                     if (not m.ordered and self._rng.random() < 0.3) else 0.0
                     for _ in msgs]
        wires = [dict(msg, _broker_seq=s) for msg, s in zip(msgs, seqs)]
        main = [w for w, e in zip(wires, extra) if e == 0.0]

        def deliver(batch):
            for w in batch:
                for fn in subs:
                    fn(dict(w))

        if main:
            t = threading.Timer(max(0.0, done - time.monotonic()), deliver, args=(main,))
            t.daemon = True
            t.start()
        for w, e in zip(wires, extra):
            if e > 0.0:
                t = threading.Timer(max(0.0, done + e - time.monotonic()),
                                    deliver, args=([w],))
                t.daemon = True
                t.start()


# ---------------------------------------------------------------------------
# Chunnels
# ---------------------------------------------------------------------------


class PubSubChunnel(Chunnel):
    """Publish/subscribe over a broker; exact-match capability per service."""

    upper_type = MSG
    lower_type = WireType.of("unit")
    multilateral = True

    def __init__(self, broker: Broker, topic: str):
        self.broker = broker
        self.topic = topic

    @property
    def name(self):
        return f"PubSub[{self.broker.model.name}]"

    def capabilities(self):
        return CapabilitySet.exact(f"pubsub:{self.broker.model.name}")

    def connect_wrap(self, inner):
        assert inner is None
        return _PubSubDP(self.broker, self.topic)


class _PubSubDP(Datapath):
    def __init__(self, broker: Broker, topic: str):
        self.broker = broker
        self.topic = topic
        self._inbox: List[dict] = []
        self._cv = threading.Condition()
        broker.subscribe(topic, self._on_msg)

    def _on_msg(self, m: dict):
        with self._cv:
            self._inbox.append(m)
            self._cv.notify_all()

    def send(self, msgs):
        self.broker.publish_batch(self.topic, msgs)

    def recv(self, buf, timeout=None):
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            while not self._inbox:
                t = None if deadline is None else deadline - time.monotonic()
                if t is not None and t <= 0:
                    return 0
                self._cv.wait(timeout=t)
            n = min(len(buf), len(self._inbox))
            buf[:n] = self._inbox[:n]
            del self._inbox[:n]
            return n


class ReceiveSideOrdering(Chunnel):
    """Reorder best-effort deliveries at the receiver using sender sequence
    numbers (valid only with a single consumer — the Fig. 5 scenario)."""

    upper_type = MSG
    lower_type = MSG
    multilateral = True  # switching to service-side ordering needs agreement

    def __init__(self, groups: int = 1):
        self.groups = groups

    @property
    def name(self):
        return "ReceiveSideOrdering"

    def capabilities(self):
        return CapabilitySet.exact("order:receive-side")

    def connect_wrap(self, inner):
        return _ReorderDP(inner, self.groups)


class _ReorderDP(Datapath):
    def __init__(self, inner, groups):
        self.inner = inner
        self.groups = groups
        self._next = defaultdict(int)
        self._held: Dict[int, dict] = {}
        self._seq = defaultdict(int)

    def send(self, msgs):
        out = []
        for m in msgs:
            m = dict(m)
            g = m.get("group", 0)
            m["_order_seq"] = self._seq[g]
            self._seq[g] += 1
            out.append(m)
        self.inner.send(out)

    def _release(self, buf, n_out):
        progress = True
        while progress and n_out < len(buf):
            progress = False
            for (g, s) in sorted(self._held):
                if s == self._next[g] and n_out < len(buf):
                    buf[n_out] = self._held.pop((g, s))
                    self._next[g] += 1
                    n_out += 1
                    progress = True
        return n_out

    def recv(self, buf, timeout=None):
        # release already-reordered messages first; only block on the inner
        # datapath when nothing is releasable
        n_out = self._release(buf, 0)
        tmp: List[Optional[dict]] = [None] * max(len(buf), 8)
        while n_out < len(buf):
            got = self.inner.recv(tmp, 0.0 if n_out else timeout)
            if not got:
                break
            for k in range(got):  # hold arrivals until their turn
                m = tmp[k]
                g = m.get("group", 0)
                self._held[(g, m.get("_order_seq", 0))] = m
            n_out = self._release(buf, n_out)
            if n_out == 0:
                # keep draining whatever is queued without blocking
                timeout = 0.02
        return n_out


class ServiceOrdering(Chunnel):
    """Identity marker: ordering delegated to the (FIFO) service."""

    upper_type = MSG
    lower_type = MSG
    multilateral = True

    @property
    def name(self):
        return "ServiceOrdering"

    def capabilities(self):
        return CapabilitySet.exact("order:service")

    def connect_wrap(self, inner):
        return _PassDP(inner)


class _PassDP(Datapath):
    def __init__(self, inner):
        self.inner = inner

    def send(self, msgs):
        self.inner.send(msgs)

    def recv(self, buf, timeout=None):
        return self.inner.recv(buf, timeout)
