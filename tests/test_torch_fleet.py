"""The port's fleet plane held against the reference's: optimistic
transactions, publishers, the aggregator and its signals, the mesh-aware
cost calibration, and the fleet-wide switch.

- The reference's classes of ``tests/test_fleet.py`` run on ``repro_torch``
  (``port_mirror``), ``TestMeshAwareCosts``'s case on ``GradHierarchical``
  included; the calibration is also held here on both packages.
- On a fake clock every run is deterministic, so the aggregate snapshots,
  the fleet controller's decisions, the store's epochs and every member's
  stack must be equal on both packages.
"""
from types import SimpleNamespace

import pytest

from port_mirror import mirror

globals().update(mirror("test_fleet.py", [
    "TestOptimisticTransactions", "TestFleetPublisher", "TestFleetAggregator", "TestSignals",
    "TestMeshAwareCosts", "TestFleetWideSwitch"]))


def _ns(pkg):
    import importlib

    names = ("core", "core.cost", "fleet", "fleet.publish", "serving.router", "comm.chunnels")
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


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt
        return self.t


def aggregates(P):
    """Three members publish on a fake clock; the aggregator folds them with
    trace, static and callback signals, through a heartbeat expiry."""
    C, F = P.core, P.fleet
    clock = FakeClock()
    store = C.KVStore()
    tels, pubs = [], []
    for i, (ops, rtt) in enumerate(((30, 0.004), (10, 0.012), (5, 0.002))):
        t = C.ConnTelemetry(now=clock)
        pubs.append(F.FleetPublisher(store, "f", f"m{i}", t, period_s=0.0, now=clock))
        tels.append((t, ops, rtt))
    clock.advance(1.0)
    for t, ops, rtt in tels:
        for _ in range(ops):
            t.record_send(1, 100, 0.001)
        for _ in range(20):
            t.record_rtt(rtt)
    for p in pubs:
        p.publish()
    sources = [F.StaticSignal({"ext.carbon_gco2": 310.0}),
               F.SpotPriceSignal([1.0, 3.5, 2.0], period_s=1.0, now=clock),
               F.CarbonIntensitySignal([200.0, 450.0], period_s=2.0, now=clock),
               F.CallbackSignal(lambda now: {"ext.now": now})]
    agg = F.FleetAggregator(store, "f", ttl_s=1.0, now=clock, sources=sources)
    out = [agg.aggregate()]
    clock.advance(0.8)
    pubs[1].publish()
    clock.advance(0.5)
    out += [agg.aggregate(), agg.expired_total, store.get("fleet/f/roster")]
    return out


def test_aggregates_equal(on_both):
    out = on_both(aggregates)
    assert out[0]["fleet.members"] == 3 and out[1]["fleet.members"] == 1


def mesh_calibration(P):
    """``calibrate_cost_models`` from a duck-typed mesh (``axis_names`` and
    ``shape[axis]``) and a bandwidth signal, then the calibrated objective."""
    CH, F = P.comm_chunnels, P.fleet
    clock = FakeClock()
    out = [CH.cost_calibration()]
    sig = F.LinkBandwidthSignal(probe=lambda: 4e9, now=clock)
    out.append(CH.calibrate_cost_models(signal=sig))
    obj = CH.calibrated_objective(P.core_cost.DEFAULT_OBJECTIVE)
    out.append((obj.name, obj.dcn_s_per_byte, obj.w_latency, obj.w_bytes))
    mesh = SimpleNamespace(axis_names=("pod", "data"), shape={"pod": 2, "data": 8})
    out.append(CH.calibrate_cost_models(mesh=mesh))
    out.append(CH.calibrate_cost_models(mesh=mesh, fast_axis="pod", link_bytes_per_s=1e9))
    out.append(CH.calibrate_cost_models(mesh=SimpleNamespace(axis_names=("x",), shape={"x": 4})))
    CH.reset_cost_calibration()
    out.append(CH.cost_calibration())
    out.append(CH.calibrated_objective(P.core_cost.LATENCY_FIRST) is P.core_cost.LATENCY_FIRST)
    return [tuple(o.__dict__.values()) if hasattr(o, "n_fast") else o for o in out]


def test_mesh_calibration_equal(on_both):
    out = on_both(mesh_calibration)
    assert out[3] == (8, 4e9) and out[4] == (2, 1e9) and out[6] == (None, None)


def fleet_switch(P, only_server_router, params, k_plan):
    """The fleet-wide switch on a fake clock: members over the routing
    Select, driven at ``k_plan`` sends per member per 0.05 s interval."""
    C, F, R = P.core, P.fleet, P.serving_router
    clock = FakeClock()
    store = C.KVStore()
    fabric = C.Fabric()
    members = []
    for i in range(3):
        ep = fabric.register(f"fcli{i}")
        if i in only_server_router:
            st = C.make_stack(R.ServerRouterChunnel(router_addr="router"), R.AddressedTransport(ep))
        else:
            st = R.routing_stack(ep, ["b0", "b1"], "router", prefer="server")
        h = C.LockedConn(st.preferred())
        h.telemetry = C.ConnTelemetry(now=clock)
        h.telemetry.bind_reconfig(h.stats)
        pub = F.FleetPublisher(store, "kv", f"cli{i}", h.telemetry, period_s=0.0, now=clock)
        m = F.FleetMember(store, "kv", f"cli{i}", h, st, publisher=pub)
        m.join()
        members.append(m)
    sources = [F.SpotPriceSignal([1.0, 1.0, 5.0, 5.0], period_s=0.2, now=clock)]
    agg = F.FleetAggregator(store, "kv", ttl_s=1.0, now=clock, sources=sources)
    ctl = F.fleet_controller(
        store, "kv", members[0].stack, policy="kv_fleet_adaptive",
        policy_params={"fleet_high_qps": 180.0, "fleet_low_qps": 110.0, "hold": 2, **params},
        pump=lambda: [m.poll(clock()) for m in members], cooldown_s=0.0, now=clock)
    ticks = []
    for k in k_plan:
        clock.advance(0.05)
        for m in members:
            for _ in range(k):
                m.handle.telemetry.record_send(1, 100, 0.001)
            m.poll(clock())
        d = ctl.tick(agg.aggregate(clock()))
        ticks.append((d.rule, d.fired, d.committed, d.reason,
                      round(d.snapshot.get("fleet.offered_qps", -1.0), 9)))
    stack = store.get(f"{F.fleet_conn_id('kv')}/stack")
    return (ticks, ctl.counts(), stack["epoch"],
            [(repr(m.handle.stack).split("(")[0], m.epoch, m.handle.stats.switches)
             for m in members])


FLEET_CASES = [
    ("load up then down", frozenset(), {}, [1] * 3 + [4] * 4 + [1] * 4),
    ("spot spike", frozenset(), {"spot_cap_usd_per_h": 2.0}, [4] * 4 + [2] * 6),
    ("member vetoes", frozenset({2}), {}, [4] * 5),
]


@pytest.mark.parametrize("case", FLEET_CASES, ids=[c[0] for c in FLEET_CASES])
def test_fleet_wide_switch_equal(on_both, case):
    ticks, counts, epoch, members = on_both(fleet_switch, *case[1:])
    assert counts["ticks"] == len(case[3])
    if case[0] == "load up then down":
        assert epoch == 3 and all(m == ("ServerRouter -> AddressedTransport", 3, 2)
                                  for m in members)
