"""The port's observability plane held against the reference's: the metrics
registry and its Prometheus text, the exporters, the traced KV-switch
scenario with ``check_records``, metrics federation, and the CLI
(``python -m repro_torch.obs``).

- The reference's classes of ``tests/test_obs.py`` run on ``repro_torch``
  (``port_mirror``), the wires on ``device="cpu"`` where the reference passes
  ``use_kernel=False``.
- Where a run is deterministic, the port's output must equal the
  reference's: the Prometheus text of one registry, the exporters' output for
  the same records, the federated view on a fixed clock, and the CLI's
  ``--slo`` and ``--fleet`` reports. The KV-switch scenario runs on the real
  clock, so its decisions, fingerprints, span names and stitched-trace
  summary are compared, not its timings.
"""
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

from port_mirror import CPU_WIRE, mirror

ROOT = Path(__file__).resolve().parents[1]

globals().update(mirror("test_obs.py", [
    "clean_tracer", "TestTracer", "TestReliableChannelStitching", "TestCompressReassemblyCtx",
    "TestWanRetransmitSpans", "TestFabricDropRecords", "TestMetricsRegistry",
    "TestFlightRecorder", "TestTelemetryWindowHandoff", "TestExport", "TestKvSwitchScenario",
    "TestFlightRecorderRotation", "TestPrometheusEdgeCases"], edits=CPU_WIRE))


def _ns(pkg):
    mods = {}
    for name in ("core", "core.rendezvous", "obs", "obs.export", "obs.metrics", "obs.federate",
                 "obs.scenario", "obs.__main__"):
        __import__(f"{pkg}.{name}")
        mods[name.replace(".", "_")] = sys.modules[f"{pkg}.{name}"]
    return SimpleNamespace(**mods)


PORT = _ns("repro_torch")


@pytest.fixture(scope="module")
def REF():
    pytest.importorskip("repro.obs")
    return _ns("repro")


@pytest.fixture
def on_both(REF):
    def run(scenario, *args):
        ref = scenario(REF, *args)
        port = scenario(PORT, *args)
        assert port == ref
        return port
    return run


class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t


def registry_text(P):
    """One registry over every family kind: fabric counters after seeded
    lossy traffic, a connection's telemetry on a fixed clock, a controller's
    lifetime counts, selected fields, a plain source, a failing source."""
    C = P.core
    f = C.Fabric(seed=3)
    a, b = f.register("a"), f.register("b")
    f.set_link("a", "b", C.LinkModel(loss=0.3))
    for k in range(6):
        a.send_batch("b", [b"x" * (k + 1)] * 8)
    clock = FakeClock()
    tel = C.ConnTelemetry(now=clock)
    for n in (1, 4, 16):
        tel.record_send(n, 100 * n, 0.002)
        tel.record_rtt(0.001 * n)
    clock.t = 2.0
    ctl = C.ReconfigController([C.Rule("hot", C.above("x", 1.0), "B", hold=1)],
                               lambda t: True, lambda: "A", now=clock)
    for x in (0.0, 2.0, 2.0):
        ctl.tick({"x": x})
    chan = SimpleNamespace(retransmits=3, timeout=0.05, retries=8, name="skip")

    def broken():
        raise RuntimeError("source down")

    reg = P.obs.MetricsRegistry()
    reg.watch("fabric", f.counters)
    reg.watch("conn", tel, instance='cli "a"')
    reg.watch("controller", ctl)
    reg.watch_fields("reliable_channel", chan, ("retransmits", "timeout", "retries"),
                     instance="b")
    reg.register("conn", lambda: {"ops_per_s": 12.5, "flag": True, "nan": float("nan"),
                                  "text": "dropped"}, instance="plain")
    reg.register("broken", broken)
    text = reg.to_prometheus()
    return text, reg.to_json(indent=1), repr(P.obs.parse_prometheus(text))


def test_prometheus_text_equal(on_both):
    text, _, _ = on_both(registry_text)
    assert "repro_fabric_sent" in text


def traced_records(P):
    T = P.obs.TRACER
    T.disable()
    T.reset()
    T.enable()
    try:
        with T.span("controller.tick", attrs={"rule": "r"}) as sp:
            sp.event("vote", peer="p")
            with T.span("2pc.prepare"):
                pass
            with T.span("2pc.commit"):
                with T.span("reconfig.swap"):
                    pass
        with T.span("reconfig.swap", attrs={"peer": True}):
            pass
        T.record_batch("fabric.send_batch", 4, 3, {"drop_reason": "loss"})
        return T.collect()
    finally:
        T.disable()
        T.reset()


def exports(P, records):
    E = P.obs_export
    return (E.to_chrome(records), E.render_timeline(records, width=40),
            E.phase_durations(records), E.stitched_trace_ids(records))


@pytest.mark.parametrize("source", ["reference", "port"])
def test_exports_equal_on_the_same_records(on_both, REF, source):
    records = traced_records(REF if source == "reference" else PORT)
    doc, timeline, phases, traces = on_both(exports, records)
    assert doc["traceEvents"] and "swap" in phases and len(traces) >= 1


def kv_switch(P):
    res = P.obs_scenario.run_kv_switch_scenario(seed=7)
    recs = res["records"]
    summary = P.obs___main__.check_records(recs)
    main = [r["name"] for r in recs
            if r["kind"] == "span" and r.get("trace_id") == summary["trace_id"]]
    samples = P.obs.parse_prometheus(res["registry"].to_prometheus())
    return (res["committed"], res["client_fp"], res["server_fp"],
            [(d["rule"], d["target"], d["fired"], d["committed"], d["reason"])
             for d in res["decisions"]],
            sorted({r["name"] for r in recs if r["kind"] == "span"}),
            sorted(set(main)), summary["swaps"],
            sorted({(s["name"], tuple(sorted(s["labels"].items()))) for s in samples}),
            P.obs.TRACER.enabled)


def test_kv_switch_scenario_equal(on_both):
    committed, client_fp, server_fp, *_, swaps, _, enabled = on_both(kv_switch)
    assert committed and client_fp == server_fp and "Compact" in client_fp
    assert swaps >= 2 and not enabled


def federation(P):
    store = P.core_rendezvous.KVStore()
    now = FakeClock(5.0)
    pubs = []
    for name, region, ops, p95 in (("edge-1", "edge", 300.0, 0.0074),
                                   ('odd"member', "edge", 20.0, 0.002),
                                   ("core-1", "core", 900.0, 0.0009)):
        reg = P.obs.MetricsRegistry()
        reg.register("conn", lambda o=ops, q=p95: {"ops_per_s": o, "rtt_p95_s": q},
                     instance=f"{name}/c")
        pub = P.obs_federate.MetricsPublisher(store, "fed", name, reg, region=region, now=now)
        pub.publish()
        pubs.append(pub)
    fed = P.obs_federate.MetricsFederator(store, "fed", ttl_s=5.0, now=now)
    out = [fed.view(), fed.merged(), fed.per_region(), fed.federated_registry().to_prometheus()]
    now.t = 8.0
    pubs[0].publish()
    now.t = 12.0  # the other two are now past their ttl
    out += [fed.view(), fed.expired_total, fed.members()]
    pubs[0].retire()
    out.append(fed.view())
    return out


def test_federation_equal(on_both):
    out = on_both(federation)
    assert "_fleet" in out[3]


@pytest.mark.parametrize("mode", ["--slo", "--fleet"])
def test_cli_reports_equal(REF, mode):
    def run(pkg):
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        r = subprocess.run([sys.executable, "-m", pkg, mode], cwd=ROOT, env=env,
                           capture_output=True, text=True, timeout=120)
        assert r.returncode == 0, r.stderr
        return r.stdout

    out = run("repro_torch.obs")
    assert out == run("repro.obs") and out.strip()


def test_cli_check(tmp_path):
    """``python -m repro_torch.obs --check``: the port's counterpart of the
    reference's observability smoke step."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-m", "repro_torch.obs",
                        "--trace", str(tmp_path / "kv.trace.json"),
                        "--metrics", str(tmp_path / "metrics.prom"), "--check"],
                       cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "kv-switch scenario: committed=True" in r.stdout
    assert "check: metrics OK" in r.stdout and "check: stitched trace OK" in r.stdout


def test_tensor_traffic_exports_as_numbers():
    """Torch tensors through a WAN link under a connection handle: no value
    the telemetry or the link's stats hand the registry is a tensor or a
    numpy scalar, which the export would drop (it keeps only ``int``,
    ``float`` and ``bool``)."""
    import threading

    import torch

    from repro_torch.comm.chunnels import WanLinkChunnel
    from repro_torch.core import Fabric, LockedConn, make_stack
    from repro_torch.obs import MetricsRegistry, parse_prometheus

    f = Fabric()
    epa, epb = f.register("wa"), f.register("wb")
    handle = LockedConn(make_stack(WanLinkChunnel(epa, "wb", mtu_bytes=1024,
                                                  device="cpu")).preferred())
    rx = WanLinkChunnel(epb, "wa", mtu_bytes=1024, device="cpu").connect_wrap(None)
    got = []

    def pump():
        buf = [None]
        while len(got) < 3 and rx.recv(buf, timeout=2.0):
            got.append(buf[0])

    t = threading.Thread(target=pump)
    t.start()
    for k in range(3):
        handle.send([torch.full((40, 50), float(k + 1))])
    t.join(timeout=10.0)
    assert not t.is_alive() and len(got) == 3
    reg = MetricsRegistry()
    reg.watch("conn", handle.telemetry, instance="wa")
    reg.register("wan", handle.dp.stats, instance="wa")
    for fam in reg.collect().values():
        for values in fam.values():
            assert not [k for k, v in values.items() if isinstance(v, torch.Tensor)
                        or type(v).__module__ == "numpy"], values
    names = {s["name"] for s in parse_prometheus(reg.to_prometheus())}
    assert {"repro_conn_bytes_out", "repro_wan_frames_sent", "repro_wan_retransmits"} <= names
    assert reg.collect()["conn"]["wa"]["bytes_out"] == 3 * 40 * 50 * 4
