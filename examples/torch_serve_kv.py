"""Serving example (paper §7.3) on the PyTorch port: a sharded KV store
whose routing stack is negotiated and reconfigured at runtime — client-side
sharding vs router.

    PYTHONPATH=src python examples/torch_serve_kv.py

The counterpart of ``examples/serve_kv.py``, on ``repro_torch.core`` and
``repro_torch.serving.router``. It runs on the host alone (the routing
plane moves no tensor): the application is written once against a Select
of two routing chunnels; the operator switches it from client-side
sharding to the router under two-phase commit, and the data written
before the switch is read back after it. ``main()`` returns the two
latency medians and the number of switches.
"""
from __future__ import annotations

from repro_torch.core import Fabric, LinkModel, LockedConn, Select, make_stack
from repro_torch.serving.router import (
    AddressedTransport,
    ClientShardChunnel,
    KVBackend,
    KVClient,
    Router,
    ServerRouterChunnel,
)


def main() -> dict:
    fabric = Fabric(default_link=LinkModel(latency_s=0.0005))
    backends = [KVBackend(fabric, f"kv{i}") for i in range(4)]
    router = Router(fabric, "router", [b.addr for b in backends])
    ep = fabric.register("cli")
    try:
        # the developer writes ONE application against a Select of routing chunnels
        stack = make_stack(
            Select(
                ClientShardChunnel(backends=tuple(b.addr for b in backends)),
                ServerRouterChunnel(router_addr="router"),
            ),
            AddressedTransport(ep),
        )
        handle = LockedConn(stack.preferred())  # preference order: client-side first
        client = KVClient(fabric, ep, handle)

        for i in range(32):
            client.request("put", f"user{i}", val={"n": i})
        lat_client = [client.request("get", f"user{i % 32}")[1] for i in range(100)]
        print(f"client-side sharding: p50 {sorted(lat_client)[50] * 1e6:.0f}us")

        # operator decision: backends will be re-provisioned -> switch to the
        # router (an administrator choice, not an application change)
        if not handle.reconfigure(stack.options()[1]):
            raise RuntimeError("the switch to the router was not committed")
        lat_router = [client.request("get", f"user{i % 32}")[1] for i in range(100)]
        print(f"after reconfigure -> router: p50 {sorted(lat_router)[50] * 1e6:.0f}us "
              f"(switches={handle.stats.switches})")

        val, _ = client.request("get", "user7")
        if val["val"] != {"n": 7}:  # data survives the routing switch
            raise RuntimeError(f"user7 read back as {val}")
    finally:
        for b in backends:
            b.close()
        router.close()
    print("serve_kv OK")
    return {"p50_client_s": sorted(lat_client)[50], "p50_router_s": sorted(lat_router)[50],
            "switches": handle.stats.switches, "user7": val["val"]}


if __name__ == "__main__":
    main()
