"""The Chunnel abstraction (Bertha §3).

A Chunnel is a single unit of communication functionality that can
  (a) transform data (serialize / compress / encrypt),
  (b) decide where data goes (shard / route / replicate), or
  (c) touch the transport (send/receive).

``connect_wrap(inner)`` composes a Chunnel over an inner Datapath, mirroring the
paper's ChunnelTransformer/ChunnelDatapath split. Datapath type safety is
enforced at stack-assembly time via WireTypes (the Rust-compile-time check is a
Python raise-at-build-time check here — both happen before any data flows).

Two chunnel families share this interface:
  * host chunnels  — move Python messages over the host fabric (pub/sub,
    routing, reliability, ordering): the paper's §7 application plane.
  * step chunnels  — transform the jitted training/serving step dataflow
    (gradient wire formats, collective schedules): the TPU "transport" plane.
    Their connect_wrap composes *trace-time*, so like Rust monomorphization the
    compiled program carries zero dynamic-dispatch overhead (verified in
    benchmarks/bench_overhead.py).
"""
from __future__ import annotations

import abc
import time
from dataclasses import dataclass, field
from typing import Any, Iterable, Optional, Sequence

from repro_torch.core.capability import CapabilitySet
from repro_torch.core.cost import NEUTRAL, CostModel
from repro_torch.obs.trace import TRACER


@dataclass(frozen=True)
class WireType:
    """Datapath data type, e.g. WireType('grads', dtype='f32')."""

    name: str
    attrs: tuple = ()  # sorted (key, value) pairs

    @staticmethod
    def of(name: str, **attrs) -> "WireType":
        return WireType(name, tuple(sorted(attrs.items())))

    def __str__(self) -> str:
        a = ",".join(f"{k}={v}" for k, v in self.attrs)
        return f"{self.name}[{a}]" if a else self.name


ANY = WireType.of("any")


def types_match(a: WireType, b: WireType) -> bool:
    return ANY in (a, b) or a == b


class Datapath(abc.ABC):
    """A live connection endpoint (the paper's ChunnelDatapath).

    The contract is batch-aware (docs/architecture.md §8): ``send`` takes the
    WHOLE batch and implementations must transform/forward it per call — one
    inner ``send``, one fabric ``send_batch``, one device program — never a
    per-element loop of singleton sends. Per-message transforms are lifted to
    the batch contract only through the explicit :func:`per_message` adapter
    (the one sanctioned per-element loop; ``repro.lint``'s
    ``per-message-hot-path`` rule flags hand-written ones). ``recv`` fills
    ``buf`` and may block up to ``timeout`` for the FIRST message only — it
    drains what is available rather than waiting for a full buffer."""

    @abc.abstractmethod
    def send(self, msgs: Iterable[Any]) -> None: ...

    @abc.abstractmethod
    def recv(self, buf: list, timeout: Optional[float] = None) -> int:
        """Fill ``buf`` with received messages; return count."""

    def close(self) -> None:
        pass


def per_message(fn: Any) -> Any:
    """Lift a per-message transform to the batch contract — the explicit
    escape hatch for transforms that genuinely cannot vectorize. This is the
    only sanctioned per-element loop on a Datapath hot path; the
    ``per-message-hot-path`` lint rule exists to flag hand-written ones."""

    def _batch(msgs: list) -> list:
        return [fn(m) for m in msgs]

    _batch.per_message = True  # type: ignore[attr-defined]
    _batch.__wrapped__ = fn  # type: ignore[attr-defined]
    return _batch


class Chunnel(abc.ABC):
    """The paper's ChunnelTransformer: wraps an inner Datapath with new
    functionality and reports type/capability metadata for negotiation."""

    #: data type accepted from the layer above / produced to the layer below
    upper_type: WireType = ANY
    lower_type: WireType = ANY
    #: True if replacing this chunnel requires agreement among all endpoints
    multilateral: bool = False

    @property
    def name(self) -> str:
        return type(self).__name__

    def capabilities(self) -> CapabilitySet:
        """Relative-compatibility labels (Bertha §5.2); opaque to the runtime."""
        return CapabilitySet.exact(self.name)

    def cost_model(self) -> CostModel:
        """Static cost annotations scored by ``repro_torch.core.cost`` during
        negotiation and controller ticks. The neutral default keeps
        unannotated chunnels out of the objective (scoring then falls back to
        preference order)."""
        return NEUTRAL

    @abc.abstractmethod
    def connect_wrap(self, inner: Optional[Datapath]) -> Datapath: ...

    def migrate_state(self, old: Optional[Datapath]) -> dict:
        """Extract transferable connection state from the implementation being
        replaced (Bertha §4.2 step 2). Default: nothing to carry."""
        return {}

    def fingerprint(self) -> str:
        caps = ";".join(sorted(str(c) for c in self.capabilities()))
        return f"{self.name}({caps})<{self.upper_type}->{self.lower_type}>"

    def __repr__(self) -> str:
        return self.name


@dataclass
class FnChunnel(Chunnel):
    """Convenience: build a transform chunnel from send/recv functions.

    ``on_send``/``on_recv`` are per-message transforms, lifted to the batch
    contract through :func:`per_message`. ``on_send_batch``/``on_recv_batch``
    take and return the whole list in one call and win when both are given —
    supply these for anything that can amortize work across the batch."""

    fn_name: str = "FnChunnel"
    on_send: Any = None
    on_recv: Any = None
    upper: WireType = ANY
    lower: WireType = ANY
    caps: Optional[CapabilitySet] = None
    multilateral_: bool = False
    cost: Optional[CostModel] = None
    on_send_batch: Any = None
    on_recv_batch: Any = None

    def __post_init__(self):
        self.upper_type = self.upper
        self.lower_type = self.lower
        self.multilateral = self.multilateral_

    @property
    def name(self) -> str:
        return self.fn_name

    def capabilities(self) -> CapabilitySet:
        return self.caps if self.caps is not None else CapabilitySet.exact(self.name)

    def cost_model(self) -> CostModel:
        return self.cost if self.cost is not None else NEUTRAL

    def connect_wrap(self, inner: Optional[Datapath]) -> Datapath:
        return _FnDatapath(self, inner)


def _approx_bytes(msgs) -> int:
    """Summed payload size of a batch, counting only sized bytes-like items
    (str/bytes); opaque objects contribute 0 — the calibration consumer
    treats a zero total as 'no byte information', not as compression."""
    return sum(len(m) for m in msgs if isinstance(m, (bytes, bytearray, str)))


class _FnDatapath(Datapath):
    def __init__(self, ch: FnChunnel, inner: Optional[Datapath]):
        self.ch = ch
        self.inner = inner
        self._send_batch = ch.on_send_batch or (
            per_message(ch.on_send) if ch.on_send else None)
        self._recv_batch = ch.on_recv_batch or (
            per_message(ch.on_recv) if ch.on_recv else None)

    def send(self, msgs):
        if not isinstance(msgs, list):
            msgs = list(msgs)
        if TRACER.enabled:  # batch-level only: see the span-in-hot-loop rule
            # timed transform + byte sizes feed calibrate_from_traces: one
            # perf_counter pair per BATCH, inside the enabled guard, so the
            # disabled path stays two attribute reads
            t0 = time.perf_counter()
            out = self._send_batch(msgs) if self._send_batch else msgs
            dur = time.perf_counter() - t0
            TRACER.record_batch(
                "chunnel.send", len(msgs), len(out),
                {"chunnel": self.ch.fn_name, "dur": dur,
                 "bytes_in": _approx_bytes(msgs),
                 "bytes_out": _approx_bytes(out)})
        else:
            out = self._send_batch(msgs) if self._send_batch else msgs
        if self.inner is not None:
            self.inner.send(out)

    def recv(self, buf, timeout=None):
        if self.inner is None:
            return 0
        n = self.inner.recv(buf, timeout)
        if self._recv_batch and n:
            out = self._recv_batch(buf[:n])
            n = min(len(out), len(buf))
            buf[:n] = out[:n]
        if TRACER.enabled and n:
            TRACER.record_batch("chunnel.recv", n, n,
                                {"chunnel": self.ch.fn_name})
        return n
