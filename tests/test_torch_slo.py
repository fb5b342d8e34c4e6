"""The port's SLO plane held against the reference's: the error-budget
engine, federation into the fleet snapshot, trace-derived cost calibration
and the ``slo_guard`` policy.

- The reference's classes of ``tests/test_slo.py`` run on ``repro_torch``
  (``port_mirror``).
- On a fake clock every run is deterministic, so the engine's signals,
  events and report over a scripted day, the calibration and the scores it
  installs, and the ``slo_guard`` controller's decisions must be equal on
  both packages. Each scenario resets both packages' calibration tables.
"""
from types import SimpleNamespace

import pytest

from port_mirror import mirror

globals().update(mirror("test_slo.py", [
    "clean_tracer", "TestSLODeclaration", "TestSLOEngine", "TestFederation",
    "TestCalibrateFromTraces", "TestSLOGuardPolicy"]))


def _ns(pkg):
    import importlib

    names = ("core", "core.cost", "comm.chunnels", "obs", "obs.slo", "obs.calibrate",
             "obs.federate", "fleet")
    return SimpleNamespace(**{n.replace(".", "_"): importlib.import_module(f"{pkg}.{n}")
                              for n in names})


PORT = _ns("repro_torch")


@pytest.fixture(scope="module")
def REF():
    pytest.importorskip("jax")
    return _ns("repro")


@pytest.fixture
def on_both(REF):
    def run(scenario, *args):
        for P in (REF, PORT):
            P.comm_chunnels.reset_cost_calibration()
        try:
            ref = scenario(REF, *args)
            port = scenario(PORT, *args)
        finally:
            for P in (REF, PORT):
                P.comm_chunnels.reset_cost_calibration()
        assert port == ref
        return port
    return run


class _Recorder:
    def __init__(self):
        self.dumps = []

    def dump(self, name, extra=None, once=False):
        self.dumps.append((name, extra, once))
        return name


def slo_day(P):
    """A healthy, burning, flapping and recovered day on a fake clock, one
    observation a second, three SLO kinds."""
    S = P.obs_slo
    rec = _Recorder()
    engine = S.SLOEngine(
        [S.latency_slo_for("conn.rtt_p95_s", 0.005, objective=0.95, name="lat"),
         S.error_ratio_slo_for("conn.error_ratio", objective=0.999, name="err"),
         S.availability_slo_for("obs.availability", objective=0.99, name="avail")],
        fast_window_s=5.0, slow_window_s=60.0, budget_window_s=3600.0, recorder=rec)
    phases = [(60, {"conn.rtt_p95_s": 0.001, "conn.error_ratio": 0.0, "obs.availability": 1.0}),
              (90, {"conn.rtt_p95_s": 0.014, "conn.error_ratio": 0.02, "obs.availability": 0.5}),
              (30, {"conn.rtt_p95_s": "n/a", "obs.availability": float("nan")}),
              (40, {"conn.rtt_p95_s": 0.009, "conn.error_ratio": 1.5}),
              (120, {"conn.rtt_p95_s": 0.0012, "conn.error_ratio": 0.0, "obs.availability": 1.0})]
    t, sigs = 0.0, []
    for ticks, view in phases:
        for _ in range(ticks):
            t += 1.0
            sigs.append(engine.observe(view, now=t))
    return sigs[::7], engine.events, engine.report(now=t), rec.dumps


def test_slo_day_equal(on_both):
    sigs, events, report, dumps = on_both(slo_day)
    assert events and dumps and {r["slo"] for r in report} == {"lat", "err", "avail"}


def _batch(ch, dur, bi=0, bo=None):
    return {"name": "chunnel.send", "kind": "batch",
            "attrs": {"chunnel": ch, "dur": dur, "bytes_in": bi, "bytes_out": bo}}


def calibration(P):
    """Trace records of three chunnels, a WAN link and two swaps folded into
    measured costs, installed, and read back by the scorer."""
    C, cost = P.core, P.core_cost
    recs = ([_batch("A", d, bi=100, bo=50) for d in (0.002, 0.003, 0.002, 0.9)]
            + [_batch("B", 0.004, bi=10, bo=40)] * 3 + [_batch("Rare", 0.1)] * 2
            + [{"name": "wan.send", "kind": "span", "dur": d, "attrs": {"chunnel": "WanLink"}}
               for d in (0.004, 0.006, 0.005)]
            + [{"name": "reconfig.swap", "kind": "span", "dur": d, "attrs": {"new": "fp1"}}
               for d in (0.01, 0.03)])
    cal = P.obs_calibrate.calibrate_from_traces(recs, min_samples=3, apply=True)
    a = C.FnChunnel(fn_name="A", cost=C.CostModel(op_latency_s=1e-6))
    b = C.FnChunnel(fn_name="B", cost=C.CostModel(op_latency_s=1e-6, dcn_bytes_per_byte=0.5))
    return (cal.chunnels, cal.samples, cal.stack_blips, bool(cal), cost.measured_costs(),
            [(c.op_latency_s, c.dcn_bytes_per_byte) for c in map(cost.chunnel_cost, (a, b))])


def test_calibration_equal(on_both):
    chunnels, samples, blips, ok, _, costs = on_both(calibration)
    assert ok and "Rare" not in chunnels and blips == {"fp1": pytest.approx(0.02)}
    assert costs[0] == (pytest.approx(0.0025), pytest.approx(0.5))


def slo_guard(P, params, stream):
    C = P.core
    cands = [C.Candidate("fast", C.CostModel(op_latency_s=1e-4), "Fast"),
             C.Candidate("safe", C.CostModel(op_latency_s=2e-3), "Safe")]
    ctx = C.PolicyContext(candidates=cands, default="fast", params={"slo": "lat", **params})
    rules = C.policy_rules("slo_guard", ctx)
    cur = {"v": "fast"}

    def switch(t):
        cur["v"] = t
        return True

    ctl = C.ReconfigController(rules, switch, lambda: cur["v"], cooldown_s=0.0,
                               now=lambda: 0.0)
    return ([(r.name, r.hold, r.priority) for r in rules],
            [(d.rule, d.target, d.fired, d.reason)
             for d in (ctl.tick(s) for s in stream)], ctl.counts())


SLO_STREAM = [{"slo.lat.burn_fast": f, "slo.lat.burn_slow": s, "slo.lat.alarm": a}
              for f, s, a in ((1.0, 1.0, 0.0), (20.0, 1.0, 0.0), (20.0, 10.0, 1.0),
                              (20.0, 10.0, 1.0), (0.5, 8.0, 1.0), (0.2, 0.5, 0.0),
                              (0.1, 0.2, 0.0))]


@pytest.mark.parametrize("params", [{"safe_names": ("Safe",)},
                                    {"safe_names": ("Safe",), "fast_burn": 2.0, "slow_burn": 1.0},
                                    {}], ids=["safe", "thresholds", "scored"])
def test_slo_guard_decisions_equal(on_both, params):
    rules, ticks, counts = on_both(slo_guard, params, SLO_STREAM)
    assert rules[0][0] == "slo_guard:lat:burn" and counts["ticks"] == len(SLO_STREAM)


def federated_slo(P):
    """Federated member metrics become the engine's view, and the engine
    feeds a fleet aggregator as a signal source."""
    now = lambda: 10.0  # noqa: E731
    store = P.core.KVStore()
    for name, region, p95 in (("e1", "edge", 0.009), ("e2", "edge", 0.002), ("c1", "core", 0.001)):
        reg = P.obs.MetricsRegistry()
        reg.register("conn", lambda q=p95: {"rtt_p95_s": q, "error_ratio": 0.0, "ops_per_s": 10.0},
                     instance=name)
        P.obs_federate.MetricsPublisher(store, "fed", name, reg, region=region, now=now).publish()
    fed = P.obs_federate.MetricsFederator(store, "fed", ttl_s=5.0, now=now)
    S = P.obs_slo
    engine = S.SLOEngine([S.latency_slo_for("obs.region.edge.conn.rtt_p95_s", 0.005,
                                            objective=0.9, name="edge_lat")],
                         fast_window_s=5.0, slow_window_s=30.0, recorder=None,
                         view_fn=fed.read)
    sigs = [engine.read(now=10.0 + k) for k in range(3)]
    agg = P.fleet.FleetAggregator(store, "fed", ttl_s=5.0, now=now, sources=[engine])
    return sigs, agg.aggregate(), fed.view()


def test_federated_slo_equal(on_both):
    sigs, snap, view = on_both(federated_slo)
    assert "slo.edge_lat.burn_fast" in snap
