"""One reconfigurable connection carrying tensors over the int8 wire.

The paper's subject end to end: two ``HostAgent``s on one ``Fabric``
negotiate a ``Select`` of two ``CompressChunnel``s (block sizes, in the
server's order of preference) over the fabric transport; the client streams
batches of float tensors; after ``swap_after`` batches the client swaps both
ends to the second wire under two-phase commit (the server is the 2PC
participant) and streams on. Every batch is received whole before the next
is sent, so the swap falls between batches and nothing is in flight.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, List, Sequence

import torch

from repro_torch.comm.wire import CompressChunnel
from repro_torch.core.fabric import Fabric
from repro_torch.core.reconfigure import LockedConn
from repro_torch.core.runtime import FabricTransport, HostAgent
from repro_torch.core.stack import Select, Stack, make_stack

CONN_ID = "wire0"


@dataclass
class SessionResult:
    received: List[List[torch.Tensor]] = field(default_factory=list)
    #: block of the wire each side had live while each batch went through
    client_blocks: List[int] = field(default_factory=list)
    server_blocks: List[int] = field(default_factory=list)
    swapped: bool = False
    client_switches: int = 0
    server_switches: int = 0
    seconds: float = 0.0  # sending and receiving every batch, the swap included


def _stack(fabric: Fabric, addr: str, peer: str, blocks: Sequence[int],
           device: str) -> Stack:
    ep = fabric.register(addr + "/data")
    return make_stack(Select(*(CompressChunnel(block=b, device=device) for b in blocks)),
                      FabricTransport(ep, peer + "/data"))


def _recv_batch(handle: LockedConn, n: int, timeout_s: float) -> List[Any]:
    buf: List[Any] = [None] * max(n, 1)
    got: List[Any] = []
    deadline = time.monotonic() + timeout_s
    while len(got) < n and time.monotonic() < deadline:
        k = handle.recv(buf, timeout=0.5)
        got.extend(buf[:k])
    if len(got) != n:
        raise TimeoutError(f"received {len(got)} of {n} tensors in {timeout_s}s")
    return got


def run_swap_session(batches: Sequence[Sequence[Any]], *,
                     blocks: Sequence[int] = (256, 64), swap_after: int = 2,
                     device: str = "cuda", timeout_s: float = 60.0) -> SessionResult:
    """Send ``batches`` over one negotiated connection, swapping from the
    ``blocks[0]`` wire to the ``blocks[1]`` wire after ``swap_after`` of them."""
    fabric = Fabric()
    server = HostAgent(fabric, "srv")
    client = HostAgent(fabric, "cli")
    res = SessionResult()
    try:
        sstack = _stack(fabric, "srv", "cli", blocks, device)
        cstack = _stack(fabric, "cli", "srv", blocks, device)
        server.listen(sstack)
        conn = client.connect("srv", cstack)
        srv_conn = LockedConn(server.accept_stack("cli"))
        server.register_participant(CONN_ID, srv_conn, sstack.find)
        t0 = time.perf_counter()
        for i, batch in enumerate(batches):
            if i == swap_after:
                target = next(o for o in cstack.options()
                              if o.chunnels[0].block == blocks[1])
                res.swapped = client.reconfigure_multilateral(
                    conn, target, ["srv"], CONN_ID)
                if not res.swapped:
                    raise RuntimeError("the 2PC swap of the wire aborted")
            conn.send(list(batch))
            res.received.append(_recv_batch(srv_conn, len(batch), timeout_s))
            res.client_blocks.append(conn.stack.chunnels[0].block)
            res.server_blocks.append(srv_conn.stack.chunnels[0].block)
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        res.seconds = time.perf_counter() - t0
        res.client_switches = conn.stats.switches
        res.server_switches = srv_conn.stats.switches
        return res
    finally:
        client.close()
        server.close()
