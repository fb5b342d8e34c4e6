"""Region gateway: the hub-side peer of the per-region stack Select.

A ``WanGateway`` terminates both options a region client can pick
(docs/architecture.md §9):

  * ``<addr>/fast`` — the clean-DCN fast path: plain ``FabricTransport``
    frames, echoed straight back to the sender (request/reply RTT probe).
  * ``<addr>/wan``  — the hostile-link path: ``WanLinkChunnel`` frames
    (go-back-N windows of MTU-sized chunks) served through a
    ``ReliableChannel`` with bounded reassembly; delivery is confirmed by
    the window acks themselves, keepalive probes are answered from the
    same handler.

One gateway serves many regions; reassembly state is bounded by
``max_partial`` so a client partitioned away mid-blob cannot pin memory.

Tensor blobs decode on ``device``: on ``"cuda"`` one launch of the Hopper
kernel ``unpack_dequant`` per blob, inside the gateway's own thread; on
``"cpu"`` its plain PyTorch version. ``"cuda"`` is the default and raises at
construction without a GPU.
"""
from __future__ import annotations

import threading
from typing import Any, Dict, List

import torch

from repro_torch.backend import resolve_device
from repro_torch.comm.wire import Reassembler, decode_blob
from repro_torch.core.fabric import Fabric, ReliableChannel


class WanGateway:
    """Serves the fast path and the WAN link for one hub address."""

    def __init__(self, fabric: Fabric, addr: str, *,
                 device: str | torch.device = "cuda",
                 max_partial: int = 64, poll_s: float = 0.005):
        self.addr = addr
        self.device = resolve_device(device)  # "cuda" without a GPU raises here
        self.poll_s = poll_s
        self.fast_ep = fabric.register(addr + "/fast")
        self.wan_ep = fabric.register(addr + "/wan")
        self._chan = ReliableChannel(self.wan_ep, peer=addr + "/wan")
        self._reasm = Reassembler(max_partial=max_partial)
        # advisory counters (GIL-ridden ints, like FabricCounters)
        self.fast_msgs = 0
        self.wan_frames = 0
        self.wan_blobs = 0
        self.wan_msgs = 0
        self.wan_pings = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _loop(self):
        bufs: List[Any] = [None] * 256
        while not self._stop.is_set():
            served = self._chan.serve_one(self._on_wan_frame,
                                          timeout=self.poll_s)
            self._pump_fast(bufs, block=not served)

    def _pump_fast(self, bufs: List[Any], *, block: bool) -> None:
        """Echo fast-path frames back to their senders, batched per source."""
        n = self.fast_ep.recv_many(bufs, timeout=self.poll_s if block else 0.0)
        if not n:
            return
        by_src: Dict[str, List[Any]] = {}
        for k in range(n):
            src, m = bufs[k]
            by_src.setdefault(src, []).append(m)
        for src, ms in by_src.items():
            self.fast_ep.send_batch(src, ms)
        self.fast_msgs += n  # lint: allow[unguarded-attr] advisory counter riding the GIL (FabricCounters convention); stats() only reads

    def _on_wan_frame(self, src: str, body: Any) -> Any:
        """ReliableChannel handler: the returned dict rides back as the ack
        body, so window acks double as delivery confirmation."""
        self.wan_frames += 1
        if isinstance(body, dict):
            if "_wire" in body:
                done = self._reasm.ingest(body)
                if done is not None:
                    payload, hdr = done
                    self.wan_blobs += 1
                    if hdr.get("kind") == "raw":
                        self.wan_msgs += 1
                    else:
                        self.wan_msgs += len(decode_blob(
                            payload, hdr, device=self.device))
                return {"ok": True}
            if "_ka" in body:
                self.wan_pings += 1
                return {"pong": True}
            if "_obj" in body:
                self.wan_msgs += 1
                return {"ok": True, "rid": body["_obj"].get("rid")
                        if isinstance(body["_obj"], dict) else None}
        self.wan_msgs += 1
        return {"ok": True}

    def stats(self) -> dict:
        return {
            "fast_msgs": self.fast_msgs,
            "wan_frames": self.wan_frames,
            "wan_blobs": self.wan_blobs,
            "wan_msgs": self.wan_msgs,
            "wan_pings": self.wan_pings,
            "partial_blobs": self._reasm.partial_count(),
            "evicted_partials": self._reasm.evicted,
            "dup_replies": self._chan.dup_replies,
        }

    def close(self):
        self._stop.set()
        self._thread.join(timeout=1.0)
        self.fast_ep.close()
        self.wan_ep.close()
