"""The chaos-regions scenario on the port, and its acceptance predicates.

``run_chaos_regions`` is the port of the reference's
``benchmarks/bench_reconfigure.py::run_chaos_regions``: two regions talk to
one ``WanGateway`` hub through the same Select [FastWire | WanLink]. A
``ChaosPlan`` puts lossy weather on every link between the WAN region and
the hub and later a short hard partition on top. Each region probes its link
every tick and feeds ``link.timeout_ratio`` and ``link.retransmit_ratio``
into its controller, so the ``wan_region_adaptive`` policy moves the lossy
region to the compressed and reliable WAN option while the clean region
stays on the fast path. The tensor blob that rides the WAN wire every other
tick goes through the int8 wire kernels on ``device``.

``assert_regions_acceptance`` holds a result to the WAN and DCN predicates of
the reference's ``_assert_chaos_acceptance``. ``tests/test_torch_chaos.py``
runs both on the CPU; ``chip_smoke.py`` runs them on the GPU.
"""
from __future__ import annotations

import time

import numpy as np

from repro_torch.chaos import ChaosInjector, ChaosPlan
from repro_torch.comm.chunnels import WanLinkChunnel  # registers the policy
from repro_torch.core import (Fabric, FabricTransport, LinkModel, LockedConn, Select,
                              conn_controller, make_stack)
from repro_torch.serving.gateway import WanGateway


def reference_blob() -> np.ndarray:
    """The scenario's deterministic tensor payload: 64 x 257 float32."""
    return np.arange(64 * 257, dtype=np.float32).reshape(64, 257) - 8000.0


def run_chaos_regions(*, fast: bool = False, device="cuda", blob=None) -> dict:
    """The scenario with the WAN links and the gateway on ``device``;
    ``blob`` (default :func:`reference_blob`) is what the WAN region sends."""
    fabric = Fabric(default_link=LinkModel(latency_s=0.0002), seed=7)
    gw = WanGateway(fabric, "hub", device=device)
    blob = reference_blob() if blob is None else blob

    class Region:
        def __init__(self, name: str):
            self.name = name
            self.ep_fast = fabric.register(f"{name}/fastlink")
            self.ep_wan = fabric.register(f"{name}/wanlink")
            self.stack = make_stack(Select(
                FabricTransport(self.ep_fast, "hub/fast", label="FastWire"),
                WanLinkChunnel(self.ep_wan, "hub/wan", mtu_bytes=2048,
                               window=8, timeout_s=0.03, retries=8, device=device),
            ))
            self.handle = LockedConn(self.stack.preferred())  # FastWire
            self.ctl = conn_controller(
                self.handle, self.stack,
                policy="wan_region_adaptive",
                policy_params={"breach_timeout_ratio": 0.05,
                               "recover_timeout_ratio": 0.01,
                               "recover_retransmit_ratio": 0.02, "hold": 2},
                cooldown_s=0.15,
            )
            self.rid = 0
            self.timeouts = self.probes = 0
            self._prev = (None, 0, 0)  # (dp id, retransmits, frames_sent)

        def on_wan(self) -> bool:
            return any(c.name == "WanLink" for c in self.handle.stack.chunnels)

        def probe(self, timeout: float = 0.08) -> None:
            self.rid += 1
            self.probes += 1
            if self.on_wan():
                # delivery is confirmed by the window acks themselves
                try:
                    self.handle.send([{"rid": self.rid}])
                except TimeoutError:
                    self.timeouts += 1
                return
            # fast path: fire-and-forget send, wait for the gateway echo
            self.handle.send([{"rid": self.rid}])
            buf = [None]
            deadline = time.monotonic() + timeout
            while True:
                t = deadline - time.monotonic()
                if t <= 0 or not self.handle.recv(buf, timeout=max(t, 0.0)):
                    self.timeouts += 1
                    return
                m = buf[0]
                if isinstance(m, dict) and m.get("rid") == self.rid:
                    return  # stale echoes of timed-out probes are skipped

        def rtx_ratio(self) -> float:
            """Windowed WAN retransmits per frame; 0.0 on the fast path."""
            if not self.on_wan():
                self._prev = (None, 0, 0)
                return 0.0
            s = self.handle.dp.stats()
            prev_id, prev_rtx, prev_fr = self._prev
            if prev_id != id(self.handle.dp):  # fresh datapath after a swap
                prev_rtx = prev_fr = 0
            d_rtx = s["retransmits"] - prev_rtx
            d_fr = s["frames_sent"] - prev_fr
            self._prev = (id(self.handle.dp), s["retransmits"], s["frames_sent"])
            return d_rtx / max(1, d_fr)

        def tick(self):
            snap = self.handle.telemetry.snapshot()
            snap["link.timeout_ratio"] = self.timeouts / max(1, self.probes)
            snap["link.retransmit_ratio"] = self.rtx_ratio()
            self.timeouts = self.probes = 0
            return self.ctl.tick(snap)

    wan, dcn = Region("wan-cli"), Region("dcn-cli")
    weather = LinkModel(latency_s=0.004, jitter_s=0.002, loss=0.25)
    plan = ChaosPlan(seed=7)
    plan.degrade("wan-cli", "hub", weather, at=0.0, label="wan-weather")
    # a short hard partition riding on the weather, pulled one tick after the
    # WAN region adopted the WAN stack: the link must absorb it (failed sends
    # and keepalive misses), not wedge or leak partial blobs
    plan.partition("wan-cli", "hub", on="storm", for_s=0.2, label="wan-storm")
    inj = ChaosInjector(fabric, plan).start()
    inj.poll()  # apply the weather before the first probe window

    max_ticks = 8 if fast else 14
    probes_per_tick = 4 if fast else 6
    storm_at = None          # tick index at which the storm fires
    post_storm = 0
    wan_switch_tick = None
    blobs_sent = 0
    try:
        for tick in range(max_ticks):
            inj.poll()
            if storm_at == tick:
                inj.fire("storm")
            for r in (wan, dcn):
                if r.on_wan():
                    r.handle.dp.ping(retries=2)  # keepalive probe
                for _ in range(probes_per_tick):
                    r.probe()
                    inj.poll()  # autoheal mid-window, not at tick granularity
                    time.sleep(0.004)
                if r.on_wan() and tick % 2 == 0:
                    blobs_sent += 1
                    try:
                        r.handle.send([blob])  # chunked + quantized tensor
                    except TimeoutError:
                        pass  # counted in failed_sends by the datapath
            for r in (wan, dcn):
                d = r.tick()
                if r is wan and wan_switch_tick is None and d.reason == "switched":
                    wan_switch_tick = tick
                    storm_at = tick + 1
            if storm_at is not None and tick > storm_at:
                post_storm += 1
            if post_storm >= 2:
                break  # storm evidence collected; no need to run the tail out
    finally:
        wan_stats = wan.handle.dp.stats() if wan.on_wan() else {}
        inj.stop()
        gw_stats = gw.stats()
        gw.close()

    def region_result(r: Region) -> dict:
        return {
            "final_stack": repr(r.handle.stack),
            "chunnels": [c.name for c in r.handle.stack.chunnels],
            "capabilities": sorted(str(c) for ch in r.handle.stack.chunnels
                                   for c in ch.capabilities()),
            "switches": [d.to_json() for d in r.ctl.switch_log()],
            "counts": r.ctl.counts(),
            "total_switches": r.handle.stats.switches,
        }

    return {
        "scenario": "chaos-regions",
        "wan": {**region_result(wan), "link_stats": wan_stats,
                "switch_tick": wan_switch_tick, "blobs_sent": blobs_sent},
        "dcn": region_result(dcn),
        "gateway": gw_stats,
        "events": inj.log,
        "weather": {"latency_s": weather.latency_s,
                    "jitter_s": weather.jitter_s, "loss": weather.loss},
        "storm_tick": storm_at,
    }


def assert_regions_acceptance(res: dict) -> None:
    """The WAN and DCN predicates of the reference's acceptance check, on a
    ``run_chaos_regions`` result of either package."""
    wan, dcn = res["wan"], res["dcn"]
    # lossy WAN region: switched by the link-health rule onto the WAN option,
    # whose capabilities spell out compressed (q8 blocks) + reliable (gbn)
    assert wan["switches"], wan
    assert wan["switches"][0]["rule"] == "lossy-wan->compressed-reliable", wan
    assert "WanLink" in wan["chunnels"], wan
    assert any("wan-gbn" in c for c in wan["capabilities"]), wan
    assert any("q8b" in c for c in wan["capabilities"]), wan
    # clean DCN region, same run: never left the fast path
    assert not dcn["switches"] and "FastWire" in dcn["chunnels"], dcn
    # the WAN wire really carried chunked+reassembled blobs and repaired loss
    assert res["gateway"]["wan_blobs"] >= 1, res
    ls = wan["link_stats"]
    assert ls.get("retransmits", 0) > 0, ls
    # the storm left evidence (failed sends or keepalive misses), not a wedge
    assert ls.get("failed_sends", 0) + ls.get("keepalive_failures", 0) > 0, ls
