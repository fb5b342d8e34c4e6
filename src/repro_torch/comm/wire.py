"""Fused compressed wire path: the host-plane chunnel that ships int8 bytes.

A whole batch of float messages becomes one flat f32 tensor on the device
(one ``torch.cat`` when the messages already lie there, else one host concat
and one host-to-device copy), then ONE kernel launch quantizes and packs it
into a single uint8 buffer (int8 codes, then the float32 scales as raw
bytes), then one device-to-host copy brings the buffer back for chunking into
fabric frames. The receive side does one host-to-device copy, one launch of
the inverse kernel, and hands back per-message views of the flat result.

The frame format and header (``shapes``, ``block``, ``n_blocks``, optional
``tc``) are those of ``repro.comm.wire``, byte for byte, so frames from either
package decode in the other — the promise of the ``wire:int8-blockq{block}``
capability.
"""
from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.backend import resolve_device
from repro_torch.comm.compress import int8_wire_ratio
from repro_torch.core.capability import CapabilitySet
from repro_torch.core.chunnel import Chunnel, Datapath, WireType
from repro_torch.core.cost import CostModel
from repro_torch.kernels.quantize.quantize import quantize_pack, unpack_dequant
from repro_torch.obs.trace import TRACER

TENSOR = WireType.of("tensor", dtype="f32")
BYTES = WireType.of("bytes")

# blob ids only disambiguate concurrent reassembly on one receiving datapath;
# process-global uniqueness is plenty
_BLOB_IDS = itertools.count(1)
_BLOB_LOCK = threading.Lock()


def _next_blob_id() -> int:
    with _BLOB_LOCK:
        return next(_BLOB_IDS)


def chunk_payload(payload: bytes, hdr: dict, *,
                  chunk_bytes: int = 1 << 16) -> List[dict]:
    """Split one blob into MTU-sized ``{"_wire": (id, k, n), "hdr", "data"}``
    fabric frames (header rides chunk 0 only).

    When tracing is enabled, the sender's current trace ctx rides the header
    (``hdr["tc"]``) so the receive side can stitch reassembly — and eviction
    under loss — back to the span that sent the blob."""
    if TRACER.enabled:
        tc = TRACER.ctx()
        if tc is not None:
            hdr = dict(hdr)  # never mutate the caller's header
            hdr["tc"] = tc
    blob_id = _next_blob_id()
    n_chunks = max(1, -(-len(payload) // chunk_bytes))
    return [{"_wire": (blob_id, k, n_chunks),
             "hdr": hdr if k == 0 else None,
             "data": payload[k * chunk_bytes:(k + 1) * chunk_bytes]}
            for k in range(n_chunks)]


def _flat_on(msgs: List[Any], pad: int, dev: torch.device) -> torch.Tensor:
    """The batch as one flat f32 tensor on ``dev``, zero-padded by ``pad``:
    one concat on the device when every message lies there, else (numpy
    arrays or CPU tensors among them) one concat on the host and one copy to
    the device. A message on any other device raises."""
    parts = [torch.as_tensor(m).reshape(-1) for m in msgs]
    for p in parts:
        if p.device != dev and p.device.type != "cpu":
            raise ValueError(f"a message lies on {p.device}, the wire encodes on {dev}")
    where = dev if all(p.device == dev for p in parts) else torch.device("cpu")
    parts = [p.to(where, torch.float32) for p in parts]
    parts.append(torch.zeros(pad, dtype=torch.float32, device=where))
    return torch.cat(parts).to(dev)


def encode_batch(msgs: List[Any], *, block: int = 256, chunk_bytes: int = 1 << 16,
                 device: str | torch.device = "cuda") -> List[dict]:
    """Batch of float tensors or arrays -> wire frames: one flat tensor on the
    device, one kernel launch, one copy back, then chunking into
    ``chunk_bytes`` fabric frames."""
    dev = resolve_device(device)
    shapes = [tuple(int(d) for d in np.shape(m)) for m in msgs]
    total = sum(int(np.prod(s)) for s in shapes)
    if total:
        pad = (-total) % block
        x2d = _flat_on(msgs, pad, dev).view(-1, block)
        payload = quantize_pack(x2d).cpu().numpy().tobytes()
        n_blocks = x2d.shape[0]
    else:
        payload = b""
        n_blocks = 0
    hdr = {"shapes": shapes, "block": block, "n_blocks": n_blocks}
    return chunk_payload(payload, hdr, chunk_bytes=chunk_bytes)


def decode_blob(payload: bytes, hdr: dict, *,
                device: str | torch.device = "cuda") -> List[torch.Tensor]:
    """Reassembled payload + header -> the original batch (dequantized), as
    views of one flat f32 tensor on ``device``."""
    dev = resolve_device(device)
    shapes = hdr["shapes"]
    n_blocks, block = hdr["n_blocks"], hdr["block"]
    if n_blocks:
        # a writable copy: torch.frombuffer on immutable bytes warns
        packed = torch.frombuffer(bytearray(payload), dtype=torch.uint8).to(dev)
        flat = unpack_dequant(packed, n_blocks, block)
    else:
        flat = torch.zeros(0, dtype=torch.float32, device=dev)
    out: List[torch.Tensor] = []
    off = 0
    for shp in shapes:
        size = int(np.prod(shp)) if shp else 1
        out.append(flat[off:off + size].view(tuple(shp)))
        off += size
    return out


class Reassembler:
    """Bounded reassembly of ``chunk_payload`` frames into whole blobs.

    ``ingest`` returns ``(payload, hdr)`` when a blob completes, else None.
    At most ``max_partial`` blobs are held; under sustained frame loss (or a
    partition mid-blob) the oldest partial is evicted, so reassembly state
    stays bounded no matter how hostile the link. Single-consumer, like the
    datapaths that own it."""

    def __init__(self, max_partial: int = 64):
        self.max_partial = max_partial
        self._partial: Dict[int, dict] = {}
        self._order: deque = deque()
        self.evicted = 0  # partial blobs dropped at the bound

    def ingest(self, frame: Any) -> Optional[tuple]:
        if not (isinstance(frame, dict) and "_wire" in frame):
            return None
        blob_id, k, n_chunks = frame["_wire"]
        st = self._partial.get(blob_id)
        if st is None:
            st = {"hdr": None, "chunks": {}, "n": n_chunks}
            self._partial[blob_id] = st
            self._order.append(blob_id)
            while len(self._order) > self.max_partial:
                victim = self._partial.pop(self._order.popleft(), None)
                if victim is not None:
                    self.evicted += 1
                    if TRACER.enabled:
                        # close the sender's span story: the blob died here
                        TRACER.event(
                            "wire.evicted",
                            attrs={"drop_reason": "reassembly_overflow",
                                   "chunks_held": len(victim["chunks"])},
                            ctx=(victim.get("hdr") or {}).get("tc"))
        if frame.get("hdr") is not None:
            st["hdr"] = frame["hdr"]
        st["chunks"][k] = frame["data"]
        if st["hdr"] is not None and len(st["chunks"]) == st["n"]:
            self._partial.pop(blob_id, None)
            payload = b"".join(st["chunks"][i] for i in range(st["n"]))
            return payload, st["hdr"]
        return None

    def partial_count(self) -> int:
        return len(self._partial)


@dataclass
class CompressChunnel(Chunnel):
    """Host-plane int8 compressed wire format (exact-match capability: every
    peer must speak it). Encodes and decodes on ``device``: on ``"cuda"`` one
    Hopper kernel launch per batch each way, on ``"cpu"`` the kernels' plain
    PyTorch versions — the same bytes either way."""

    block: int = 256
    chunk_bytes: int = 1 << 16
    device: str = "cuda"

    upper_type = TENSOR
    lower_type = BYTES
    multilateral = True

    def __post_init__(self):
        resolve_device(self.device)  # "cuda" without a GPU raises here

    @property
    def name(self) -> str:
        return f"CompressWire[b{self.block}]"

    def capabilities(self) -> CapabilitySet:
        return CapabilitySet.exact(f"wire:int8-blockq{self.block}")

    def cost_model(self) -> CostModel:
        return CostModel(op_latency_s=5e-4,
                         dcn_bytes_per_byte=int8_wire_ratio(self.block),
                         switch_blip_s=1e-3)

    def connect_wrap(self, inner: Optional[Datapath]) -> Datapath:
        return _CompressDP(self, inner)


class _CompressDP(Datapath):
    """Fused-wire datapath: encode the whole batch in one kernel launch,
    chunk, and reassemble/decode on the receive side."""

    MAX_PARTIAL = 64  # bound reassembly state under frame loss

    def __init__(self, ch: CompressChunnel, inner: Optional[Datapath]):
        self.ch = ch
        self.inner = inner
        self._reasm = Reassembler(max_partial=self.MAX_PARTIAL)
        self._ready: deque = deque()

    def send(self, msgs):
        msgs = list(msgs)
        if not msgs:
            return
        frames = encode_batch(msgs, block=self.ch.block,
                              chunk_bytes=self.ch.chunk_bytes,
                              device=self.ch.device)
        if self.inner is not None:
            self.inner.send(frames)

    def recv(self, buf, timeout=None):
        n_out = self._drain(buf, 0)
        if self.inner is None:
            return n_out
        tmp: List[Any] = [None] * max(len(buf), 8)
        deadline = None if timeout is None else time.monotonic() + timeout
        while n_out < len(buf):
            if n_out:
                t: Optional[float] = 0.0  # drain-only once delivering
            elif deadline is None:
                t = None
            else:
                t = deadline - time.monotonic()
                if t <= 0:
                    break  # partial blobs are kept for the next call
            got = self.inner.recv(tmp, t)
            if not got:
                break
            for k in range(got):  # reassemble chunked blobs
                self._ingest(tmp[k])
            n_out = self._drain(buf, n_out)
        return n_out

    def _ingest(self, frame) -> None:
        done = self._reasm.ingest(frame)
        if done is not None:
            payload, hdr = done
            if TRACER.enabled:
                # parented to the SENDER's span via the header trace ctx:
                # this is where a trace crosses chunking + reassembly
                TRACER.event("wire.reassembled",
                             attrs={"bytes": len(payload),
                                    "msgs": len(hdr.get("shapes") or ())},
                             ctx=hdr.get("tc"))
            self._ready.extend(decode_blob(payload, hdr, device=self.ch.device))

    def _drain(self, buf, n_out: int) -> int:
        while n_out < len(buf) and self._ready:
            buf[n_out] = self._ready.popleft()
            n_out += 1
        return n_out
