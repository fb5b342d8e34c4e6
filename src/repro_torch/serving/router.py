"""Sharded key-value serving with reconfigurable load balancing (paper §7.3).

Two routing chunnels over the host fabric:

  ClientShardChunnel  the client evaluates hash(key) % n_shards and sends
                      DIRECTLY to the owning backend (no extra hop). Negotiation
                      hands the client a nonce so backends accept its requests.
  ServerRouterChunnel requests go to a router process which forwards to the
                      right backend (extra hop + router queueing, but backends
                      can be re-provisioned without touching clients).

The benchmark (benchmarks/bench_sharding.py ~ Fig. 6) measures p50/p95 latency
vs offered load for both, and the reconfiguration between them mid-run;
``routing_stack()`` packages the two as a Select so a ReconfigController can
switch them from live telemetry (benchmarks/bench_reconfigure.py closes that
loop end-to-end).
"""
from __future__ import annotations

import hashlib
import itertools
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from repro_torch.core import Fabric, FabricTransport, LinkModel, Select, Stack, make_stack
from repro_torch.core.capability import CapabilitySet
from repro_torch.core.chunnel import Chunnel, Datapath, WireType
from repro_torch.core.controller import (
    PolicyContext,
    Rule,
    above,
    all_of,
    below,
    register_policy,
)
from repro_torch.core.cost import CostModel

KV_REQ = WireType.of("kvreq")


def shard_of(key: str, n: int) -> int:
    return int(hashlib.md5(key.encode()).hexdigest(), 16) % n


class KVBackend:
    """One shard server: applies PUT/GET against a local dict."""

    def __init__(self, fabric: Fabric, addr: str, *, service_time_s: float = 0.0):
        self.addr = addr
        self.ep = fabric.register(addr)
        self.data: Dict[str, Any] = {}
        self.service_time_s = service_time_s
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _loop(self):
        while not self._stop.is_set():
            got = self.ep.recv(timeout=0.05)
            if got is None:
                continue
            src, msg = got
            if not isinstance(msg, dict) or "op" not in msg:
                continue
            if self.service_time_s:
                time.sleep(self.service_time_s)
            if msg["op"] == "put":
                self.data[msg["key"]] = msg["val"]
                out = {"ok": True, "rid": msg["rid"]}
            else:
                out = {"ok": True, "val": self.data.get(msg["key"]), "rid": msg["rid"]}
            self.ep.send(msg["reply_to"], out)

    def close(self):
        self._stop.set()
        self._thread.join(timeout=1.0)
        self.ep.close()


class Router:
    """Extra-hop router used by the server-side chunnel."""

    def __init__(self, fabric: Fabric, addr: str, backends: List[str]):
        self.addr = addr
        self.ep = fabric.register(addr)
        self.backends = backends
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _loop(self):
        while not self._stop.is_set():
            got = self.ep.recv(timeout=0.05)
            if got is None:
                continue
            src, msg = got
            if isinstance(msg, dict) and "key" in msg:
                self.ep.send(self.backends[shard_of(msg["key"], len(self.backends))], msg)

    def close(self):
        self._stop.set()
        self._thread.join(timeout=1.0)
        self.ep.close()


@dataclass
class ClientShardChunnel(Chunnel):
    """Client-side sharding: compositional capability (one side suffices)."""

    backends: tuple = ()
    upper_type = KV_REQ
    lower_type = KV_REQ

    @property
    def name(self):
        return "ClientShard"

    def capabilities(self):
        return CapabilitySet.compose("route:client-shard")

    def cost_model(self):
        # direct to the owning backend: no extra hop, no router queueing
        return CostModel(op_latency_s=1.6e-3, switch_blip_s=1e-4)

    def connect_wrap(self, inner):
        return _RoutedDP(self, inner, lambda m: self.backends[
            shard_of(m["key"], len(self.backends))])


@dataclass
class ServerRouterChunnel(Chunnel):
    router_addr: str = "router"
    upper_type = KV_REQ
    lower_type = KV_REQ

    @property
    def name(self):
        return "ServerRouter"

    def capabilities(self):
        return CapabilitySet.compose("route:server")

    def cost_model(self):
        # one extra hop + router queueing, but backends re-provision freely
        return CostModel(op_latency_s=2.4e-3, switch_blip_s=1e-4)

    def connect_wrap(self, inner):
        return _RoutedDP(self, inner, lambda m: self.router_addr)


class _RoutedDP(Datapath):
    def __init__(self, ch, inner, pick):
        self.ch = ch
        self.inner = inner
        self.pick = pick

    def send(self, msgs):
        out = []
        for m in msgs:  # annotate routing decisions; forwarded as ONE batch
            m = dict(m)
            m["_route_to"] = self.pick(m)
            out.append(m)
        if self.inner is not None and out:
            self.inner.send(out)

    def recv(self, buf, timeout=None):
        return self.inner.recv(buf, timeout) if self.inner else 0


class AddressedTransport(Chunnel):
    """Transport that honours the routing decision in ``_route_to``."""

    upper_type = KV_REQ
    lower_type = WireType.of("unit")

    def __init__(self, ep):
        self.ep = ep

    @property
    def name(self):
        return "AddressedTransport"

    def connect_wrap(self, inner):
        ep = self.ep

        class DP(Datapath):
            def send(self, msgs):
                by_dst: Dict[str, list] = {}
                for m in msgs:  # group by destination; one send_batch per peer
                    by_dst.setdefault(m.pop("_route_to"), []).append(m)
                for dst, batch in by_dst.items():
                    ep.send_batch(dst, batch)

            def recv(self, buf, timeout=None):
                tmp: List[Any] = [None] * len(buf)
                got = ep.recv_many(tmp, timeout=timeout)
                for k in range(got):
                    buf[k] = tmp[k][1]
                return got

        return DP()


@register_policy("kv_load_adaptive")
def kv_load_adaptive_policy(ctx: PolicyContext) -> List[Rule]:
    """The §7.3 load-balancing policy, shipped through the plugin registry:
    offered load above ``high_ops_per_s`` moves the routing Select to the
    direct ClientShard option (no router hop/queueing under load); load
    draining below ``low_ops_per_s`` moves back to ServerRouter (backends
    re-provisionable behind the router). Keep the two thresholds apart — the
    gap is the hysteresis band."""
    p = ctx.params
    high = p.get("high_ops_per_s", 150.0)
    low = p.get("low_ops_per_s", 120.0)
    hold = p.get("hold", 2)
    return [
        Rule("high-load->client-shard", above("ops_per_s", high),
             ctx.candidate_named("ClientShard").target, hold=hold, priority=1),
        Rule("low-load->server-router", below("ops_per_s", low),
             ctx.candidate_named("ServerRouter").target, hold=hold, priority=0),
    ]


@register_policy("kv_fleet_adaptive")
def kv_fleet_adaptive_policy(ctx: PolicyContext) -> List[Rule]:
    """The §7.3 load-balancing policy at FLEET scope: predicates read the
    ``FleetAggregator`` snapshot (``fleet.*``/``ext.*`` keys), and the rules
    run in a ``repro_torch.fleet.fleet_controller`` so the switch commits once,
    fleet-wide, in a single rendezvous epoch — instead of N per-client
    controllers crossing their own thresholds at their own times.

      fleet.offered_qps > fleet_high_qps  ⇒ ClientShard (direct; no router
                                            hop/queueing under aggregate load)
      fleet.offered_qps < fleet_low_qps   ⇒ ServerRouter (backends
                                            re-provisionable behind the router)

    With ``spot_cap_usd_per_h`` set, a MULTI-SOURCE clause combines the fleet
    aggregate with an external ``SignalSource`` value: a spot-price spike
    while aggregate load is below the high-water mark consolidates traffic
    behind the router (priority between the two load rules), so operators can
    shrink the backend fleet while the market is expensive.

    With ``slo`` set (an SLO name whose ``slo.*`` signals reach the fleet
    snapshot — ``aggregator.add_source(engine)``), a burn-rate clause
    OUTRANKS both load rules: an alarmed latency budget moves traffic to the
    direct ClientShard path (drops the router hop) regardless of where
    offered load sits — intent-level arming, not raw thresholds."""
    p = ctx.params
    high = p.get("fleet_high_qps", 200.0)
    low = p.get("fleet_low_qps", 120.0)
    hold = p.get("hold", 2)
    rules = [
        Rule("fleet-high-load->client-shard", above("fleet.offered_qps", high),
             ctx.candidate_named("ClientShard").target, hold=hold, priority=2),
        Rule("fleet-low-load->server-router", below("fleet.offered_qps", low),
             ctx.candidate_named("ServerRouter").target, hold=hold, priority=0),
    ]
    spot_cap = p.get("spot_cap_usd_per_h")
    if spot_cap is not None:
        rules.insert(1, Rule(
            "fleet-spot-spike->server-router",
            all_of(above("ext.spot_usd_per_h", spot_cap),
                   below("fleet.offered_qps", high)),
            ctx.candidate_named("ServerRouter").target,
            hold=hold, priority=1))
    slo = p.get("slo")
    if slo is not None:
        rules.insert(0, Rule(
            "fleet-slo-burn->client-shard",
            above(f"slo.{slo}.alarm", 0.5),
            ctx.candidate_named("ClientShard").target,
            hold=p.get("slo_hold", 1), priority=3))
    return rules


def routing_stack(ep, backends, router_addr: str = "router", *,
                  prefer: str = "server") -> Stack:
    """The §7.3 routing Select over the addressed transport: ServerRouter
    (backends re-provisionable behind the router) vs ClientShard (direct to
    the owning backend — no hop, no router queueing). ``prefer`` sets the
    operator's default; the reconfiguration controller switches between the
    two options at runtime from offered-load/latency telemetry."""
    cs = ClientShardChunnel(backends=tuple(backends))
    sr = ServerRouterChunnel(router_addr=router_addr)
    first, second = (sr, cs) if prefer == "server" else (cs, sr)
    return make_stack(Select(first, second), AddressedTransport(ep))


class KVClient:
    """Issues requests through a (reconfigurable) routing stack."""

    def __init__(self, fabric: Fabric, addr: str, handle):
        self.ep = fabric.register(addr) if isinstance(addr, str) else addr
        self.addr = self.ep.addr
        self.handle = handle  # ConnHandle over a routing stack
        self._rid = itertools.count()

    def request(self, op: str, key: str, val=None, timeout: float = 2.0):
        rid = next(self._rid)
        tel = getattr(self.handle, "telemetry", None)
        t0 = time.perf_counter()
        self.handle.send([{"op": op, "key": key, "val": val, "rid": rid,
                           "reply_to": self.addr}])
        buf = [None]
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            n = self.handle.recv(buf, timeout=0.05)
            if n and isinstance(buf[0], dict) and buf[0].get("rid") == rid:
                lat = time.perf_counter() - t0
                if tel is not None:
                    tel.record_rtt(lat)
                return buf[0], lat
        if tel is not None:
            tel.record_rtt(timeout)  # timeouts must drag p95 up, not vanish
        raise TimeoutError(f"kv {op} {key}")
