"""The port's controller, telemetry, cost scorer and policy registry held
against the reference's.

Two halves:

- the reference's own test classes of ``tests/test_controller.py`` and
  ``tests/test_policy.py`` that need only the core, run on ``repro_torch``
  (``port_mirror``), with the reference's assertions. The case that passes
  the dropped legacy alias ``max_decisions`` reads ``max_history`` here;
- each of those classes' scenarios as a function of the core package, run on
  ``repro.core`` and on ``repro_torch.core`` (``on_both``): every decision,
  snapshot, score and pick of the port must equal the reference's.

The trainer's classes (``TestTrainerControllerPlane``,
``TestTrainerDefaultPolicy``) wait for the port's trainer.
"""
import random
import time
from types import SimpleNamespace

import pytest

import repro_torch.core as port_core
import repro_torch.core.controller as port_controller
import repro_torch.core.reconfigure as port_reconfigure
from port_mirror import mirror

globals().update(mirror("test_controller.py", [
    "TestEwmaQuantile", "TestTelemetry", "TestControllerPolicy",
    "TestConnControllerIntegration", "TestPreparedPeerResync"],
    edits=[("lambda t: True, lambda: \"A\", max_decisions=10)",
            "lambda t: True, lambda: \"A\", max_history=10)")]))
globals().update(mirror("test_policy.py", [
    "TestCostModel", "TestScoredNegotiation", "TestScoredTarget",
    "TestPolicyRegistry", "TestConnControllerPolicyPath", "TestScorerInNegotiator"]))


def namespace(core, controller, reconfigure):
    ns = SimpleNamespace(**{k: getattr(core, k) for k in core.__all__})
    ns.ReconfigParticipant = reconfigure.ReconfigParticipant
    ns.ReconfigStats = reconfigure.ReconfigStats
    ns.POLICIES = controller._POLICIES
    return ns


PORT = namespace(port_core, port_controller, port_reconfigure)


@pytest.fixture(scope="module")
def REF():
    core = pytest.importorskip("repro.core")
    import repro.core.controller as controller
    import repro.core.reconfigure as reconfigure
    return namespace(core, controller, reconfigure)


@pytest.fixture
def on_both(REF):
    def run(scenario, *args):
        """``scenario(C, *args)`` on the reference core, then on the port's;
        the port must come out as the reference does. Returns the outcome."""
        ref = scenario(REF, *args)
        port = scenario(PORT, *args)
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


def T(C, name, upper="obj", lower="unit", caps=None, multilateral=False):
    return C.FnChunnel(fn_name=name, upper=C.WireType.of(upper),
                       lower=C.WireType.of(lower), caps=caps,
                       multilateral_=multilateral)


# -- telemetry estimators -------------------------------------------------------


def ewma_quantiles(C):
    rng = random.Random(0)
    p50, p95 = C.EwmaQuantile(0.50), C.EwmaQuantile(0.95)
    for _ in range(5000):
        x = rng.uniform(0.0, 1.0)
        p50.update(x)
        p95.update(x)
    shift = C.EwmaQuantile(0.5)
    trace = []
    for v in [1.0] * 300 + [10.0] * 600:
        shift.update(v)
        trace.append(shift.value)
    return p50.value, p95.value, trace


def telemetry_snapshots(C):
    clock = FakeClock()
    t = C.ConnTelemetry(now=clock)
    for _ in range(10):
        t.record_send(2, 100, 0.001)
    clock.advance(2.0)
    out = [t.snapshot()]
    clock.advance(1.0)
    out.append(t.snapshot())
    for n in (1, 1, 3, 8, 64, 0):
        t.record_send(n, 10 * n, 0.001)
    out.append(t.snapshot())
    strag = C.ConnTelemetry(now=clock)
    ratios = []
    for pods in ({"a": 0.1}, {"b": 0.1, "c": 0.3}, {"a": 0.1, "b": 0.3}):
        for _ in range(30):
            strag.record_step(pods)
        ratios.append(strag.straggler_ratio())
    st = C.ReconfigStats()
    strag.bind_reconfig(st)
    st.switches, st.last_switch_s = 2, 0.5
    out.append(strag.snapshot())
    return out, ratios


def test_ewma_quantiles_equal(on_both):
    p50, p95, _ = on_both(ewma_quantiles)
    assert 0.3 < p50 < 0.7 < 0.75 < p95


def test_telemetry_snapshots_equal(on_both):
    snaps, ratios = on_both(telemetry_snapshots)
    assert snaps[0]["ops_per_s"] == pytest.approx(5.0)
    assert ratios[0] == 1.0


# -- controller damping: one table of rule sets and snapshot streams ------------


def R(C, name, metric, op, thr, target, **kw):
    pred = (C.above if op == ">" else C.below)(metric, thr)
    return C.Rule(name, pred, target, **kw)


#: (label, rules as (name, metric, op, threshold, target, kwargs), stream of
#: (snapshot, clock advance), controller kwargs, refuse)
CONTROLLER_CASES = [
    ("hysteresis", [("hot", "x", ">", 1.0, "B", {"hold": 3})],
     [({"x": v}, 0.0) for v in (2, 2, 0, 2, 2, 2)], {}, False),
    ("no flap", [("hot", "x", ">", 1.0, "B", {"hold": 2, "priority": 1}),
                 ("cold", "x", "<", 1.0, "A", {"hold": 2})],
     [({"x": 2.0 if i % 2 == 0 else 0.0}, 0.0) for i in range(60)], {}, False),
    ("cooldown", [("hot", "x", ">", 1.0, "B", {"hold": 1, "priority": 1}),
                  ("cold", "x", "<", 1.0, "A", {"hold": 1})],
     [({"x": 2.0}, 1.0), ({"x": 0.0}, 20.0), ({"x": 0.0}, 0.0)],
     {"cooldown_s": 10.0}, False),
    ("current target", [("same", "x", ">", 1.0, "A", {"hold": 1})],
     [({"x": 2.0}, 0.0)] * 5, {}, False),
    ("priority ties", [("lo", "x", ">", 1.0, "B", {"hold": 1, "priority": 0}),
                       ("hi", "x", ">", 1.0, "C", {"hold": 1, "priority": 5})],
     [({"x": 2.0}, 0.0)], {}, False),
    ("refused", [("hot", "x", ">", 1.0, "B", {"hold": 1})],
     [({"x": 2.0}, 0.0)] * 2, {"cooldown_s": 10.0}, True),
    ("missing metric", [("hot", "x", ">", 1.0, "B", {"hold": 1})],
     [({"y": 5.0}, 0.0)], {}, False),
    ("high priority suppresses", [("strag", "x", ">", 1.0, "B", {"hold": 1, "priority": 2}),
                                  ("budget", "y", ">", 1.0, "C", {"hold": 1, "priority": 1})],
     [({"x": 2.0, "y": 2.0}, 0.0)] * 10, {}, False),
    ("bounded log, max_history", [("hot", "x", ">", 1.0, "B", {"hold": 99})],
     [({"x": 0.0}, 0.0)] * 50, {"max_history": 10}, False),
    ("counts survive eviction", [("hot", "x", ">", 1.0, "B", {"hold": 1})],
     [({"x": 2.0}, 0.0)] * 20, {"max_history": 5, "cooldown_s": 0.0, "pin": True}, False),
    ("refused counts", [("hot", "x", ">", 1.0, "B", {"hold": 1})],
     [({"x": 2.0}, 0.0)] * 9, {"max_history": 4, "cooldown_s": 0.0}, True),
]


def controller_run(C, rules, stream, kw, refuse):
    kw = dict(kw)
    pin = kw.pop("pin", False)  # the current target never changes
    clock = FakeClock()
    committed = []
    cur = {"v": "A"}

    def switch(target):
        if refuse:
            return False
        committed.append(target)
        if not pin:
            cur["v"] = target
        return True

    ctl = C.ReconfigController([R(C, *r[:5], **r[5]) for r in rules], switch,
                               lambda: cur["v"], now=clock,
                               **{"cooldown_s": 0.0, **kw})
    ticks = []
    for snap, dt in stream:
        ticks.append(ctl.tick(snap).to_json())
        clock.advance(dt)
    return (ticks, committed, [d.to_json() for d in ctl.decisions],
            [d.to_json() for d in ctl.switch_log()], ctl.counts())


@pytest.mark.parametrize("case", CONTROLLER_CASES, ids=[c[0] for c in CONTROLLER_CASES])
def test_controller_decisions_equal(on_both, case):
    _, rules, stream, kw, refuse = case
    ticks, committed, decisions, _, counts = on_both(controller_run, rules, stream, kw, refuse)
    assert counts["ticks"] == len(stream)
    if "max_history" in kw:
        assert len(decisions) == kw["max_history"]


def test_duplicate_rule_names_rejected_on_both(REF):
    for C in (REF, PORT):
        with pytest.raises(ValueError):
            C.ReconfigController([R(C, "r", "x", ">", 1.0, "B"), R(C, "r", "y", "<", 1.0, "C")],
                                 lambda t: True, lambda: "A")


def test_dropped_legacy_aliases():
    """The port keeps the reference's canonical names only: the controller
    takes ``max_history`` (the reference also takes ``max_decisions``) and
    the fabric's counters are read through ``counters.snapshot()`` (the
    reference also has ``Fabric.sent_msgs``/``sent_bytes``)."""
    with pytest.raises(TypeError):
        PORT.ReconfigController([], lambda t: True, lambda: "A", max_decisions=10)
    assert not hasattr(PORT.Fabric(), "sent_msgs")
    assert not hasattr(PORT.Fabric(), "sent_bytes")


# -- controller on a live connection ----------------------------------------------


def unilateral_switch(C):
    fabric = C.Fabric()
    ep = fabric.register("ctl-uni")
    stack = C.make_stack(C.Select(T(C, "A", "bytes", "bytes"), T(C, "B", "bytes", "bytes")),
                         C.FabricTransport(ep, "sink"))
    handle = C.LockedConn(stack.preferred())
    ctl = C.conn_controller(handle, stack,
                            [C.Rule("busy", C.above("ops_per_s", 10.0),
                                    C.option_named(stack, "B"), hold=2)],
                            cooldown_s=0.0)
    out = []
    for _ in range(2):
        for _ in range(100):
            handle.send([b"x"])
        d = ctl.tick(handle.telemetry.snapshot())
        out.append((d.rule, d.target, d.fired, d.committed, d.reason))
    snap = handle.telemetry.snapshot()
    return out, handle.stack.chunnels[0].name, snap["switches"], snap["ops"]


def multilateral_switch(C):
    fabric = C.Fabric()
    srv, cli = C.HostAgent(fabric, "ctl-srv"), C.HostAgent(fabric, "ctl-cli")
    try:
        caps = C.CapabilitySet.exact("x")
        stack = C.make_stack(C.Select(T(C, "A", caps=caps, multilateral=True),
                                      T(C, "B", caps=caps, multilateral=True)))
        srv.listen(stack)
        conn = cli.connect("ctl-srv", stack)
        before = conn.stack.chunnels[0].name
        srv_handle = C.LockedConn(srv.accept_stack("ctl-cli"))
        srv.register_participant("c1", srv_handle, stack.find)
        ctl = C.conn_controller(conn, stack,
                                [C.Rule("go", C.above("ops", -1.0),
                                        C.option_named(stack, "B"), hold=1)],
                                agent=cli, peers=["ctl-srv"], conn_id="c1", cooldown_s=0.0)
        d = ctl.tick(conn.telemetry.snapshot())
        return (before, d.committed, d.reason, conn.stack.chunnels[0].name,
                srv_handle.stack.chunnels[0].name)
    finally:
        srv.close()
        cli.close()


def multilateral_without_agent(C):
    stack = C.make_stack(C.Select(T(C, "A", multilateral=True), T(C, "B", multilateral=True)))
    try:
        C.conn_controller(C.LockedConn(stack.preferred()), stack,
                          [C.Rule("go", C.above("ops", -1.0), C.option_named(stack, "B"),
                                  hold=1)])
    except ValueError as e:
        return "multilateral" in str(e)
    return None


def test_conn_controller_outcomes_equal(on_both):
    assert on_both(unilateral_switch)[1] == "B"
    assert on_both(multilateral_switch) == ("A", True, "switched", "B", "B")
    assert on_both(multilateral_without_agent) is True


# -- prepared-peer resync ---------------------------------------------------------


def resync_sequence(C, ending):
    clock = FakeClock()
    caps = C.CapabilitySet.exact("x")
    stack = C.make_stack(C.Select(T(C, "A", caps=caps, multilateral=True),
                                  T(C, "B", caps=caps, multilateral=True)))
    handle = C.LockedConn(stack.preferred())
    part = C.ReconfigParticipant(handle, stack.find, resync_after_s=1.0, now=clock)
    target = C.option_named(stack, "B")
    steps = [part.handle_msg("coord", {"type": "reconfig_prepare",
                                       "fp": target.fingerprint()})["type"],
             part.needs_resync()]
    clock.advance(2.0)
    steps.append(part.needs_resync())
    state = {"commit": {"type": "reconfig_state", "epoch": 1, "fp": target.fingerprint()},
             "abort": {"type": "reconfig_state", "epoch": 0,
                       "fp": stack.preferred().fingerprint()},
             "pending": {"type": "reconfig_state", "epoch": 0,
                         "fp": stack.preferred().fingerprint(), "pending": True},
             "refuse": {"type": "reconfig_refuse"}}[ending]
    steps += [part.apply_state(state), part.needs_resync()]
    if ending == "pending":
        clock.advance(2.0)
        steps.append(part.needs_resync())
        steps.append(part.handle_msg("coord", {"type": "reconfig_commit",
                                               "fp": target.fingerprint(),
                                               "epoch": 1})["type"])
    return steps, handle.stack.chunnels[0].name, part.epoch


@pytest.mark.parametrize("ending", ["commit", "abort", "pending", "refuse"])
def test_prepared_peer_resync_equal(on_both, ending):
    steps, name, epoch = on_both(resync_sequence, ending)
    assert steps[:3] == ["reconfig_ready", None, "coord"]
    assert name == ("B" if ending in ("commit", "pending") else "A")


def decided_epoch_query(C):
    fabric = C.Fabric()
    coord, querier = C.HostAgent(fabric, "rs-dec"), C.HostAgent(fabric, "rs-q")
    caps = C.CapabilitySet.exact("x")
    stack = C.make_stack(C.Select(T(C, "A", caps=caps, multilateral=True),
                                  T(C, "B", caps=caps, multilateral=True)))
    handle = C.LockedConn(stack.preferred())
    target = C.option_named(stack, "B")
    try:
        coord.coordinate("c1", handle)
        coord.record_decision("c1", handle.stats.switches + 1, target.fingerprint())
        out = [querier.request("rs-dec", {"type": "reconfig_query", "conn": "c1"})]
        handle.reconfigure(target)
        out.append(querier.request("rs-dec", {"type": "reconfig_query", "conn": "c1"}))
        return [(r["type"], r["epoch"], r["fp"] == target.fingerprint()) for r in out]
    finally:
        coord.close()
        querier.close()


def agent_loop_resync(C):
    fabric = C.Fabric()
    coord, peer = C.HostAgent(fabric, "rs-coord"), C.HostAgent(fabric, "rs-peer")
    caps = C.CapabilitySet.exact("x")
    stack = C.make_stack(C.Select(T(C, "A", caps=caps, multilateral=True),
                                  T(C, "B", caps=caps, multilateral=True)))
    peer_handle = C.LockedConn(stack.preferred())
    peer.register_participant("c1", peer_handle, stack.find, resync_after_s=0.2)
    coord_handle = C.LockedConn(stack.preferred())
    target = C.option_named(stack, "B")
    try:
        r = coord.request("rs-peer", {"type": "reconfig_prepare",
                                      "fp": target.fingerprint(), "conn": "c1"})
        coord.coordinate("c1", coord_handle)
        coord_handle.reconfigure(target)
        deadline = time.monotonic() + 3.0
        while time.monotonic() < deadline and peer_handle.stack.chunnels[0].name != "B":
            time.sleep(0.02)
        return r["type"], peer_handle.stack.chunnels[0].name
    finally:
        coord.close()
        peer.close()


def test_resync_over_agents_equal(on_both):
    assert on_both(decided_epoch_query) == [("reconfig_state", 1, True)] * 2
    assert on_both(agent_loop_resync) == ("reconfig_ready", "B")


# -- cost model, scored negotiation, scored targets -------------------------------


def impl(C, name, lat=0.0, ratio=1.0, blip=0.0, caps=None):
    return C.FnChunnel(fn_name=name, caps=caps or C.CapabilitySet.exact("wire:obj"),
                       cost=C.CostModel(op_latency_s=lat, dcn_bytes_per_byte=ratio,
                                        switch_blip_s=blip))


def cost_values(C):
    st = C.make_stack(impl(C, "A", lat=1e-3, ratio=0.5, blip=0.1),
                      impl(C, "B", lat=2e-3, ratio=0.5, blip=0.2)).preferred()
    c = C.stack_cost(st)
    plain = C.stack_cost(C.make_stack(C.FnChunnel(fn_name="Plain")).preferred())
    m = C.CostModel(op_latency_s=1e-3, dcn_bytes_per_byte=1.0)
    fat = C.CostModel(op_latency_s=3e-3, dcn_bytes_per_byte=1.0)
    lean = C.CostModel(op_latency_s=5e-3, dcn_bytes_per_byte=0.25)
    slow_cheap = C.CostModel(op_latency_s=10.0, dcn_bytes_per_byte=0.1)
    fast_fat = C.CostModel(op_latency_s=1e-6, dcn_bytes_per_byte=1.0)
    snap = {"ops_per_s": 100.0, "bytes_per_s": 1e6}
    objectives = [C.Objective(w_latency=0.0, w_bytes=1.0), C.Objective(w_latency=1.0, w_bytes=0.0),
                  C.BYTES_FIRST, C.LATENCY_FIRST, C.DEFAULT_OBJECTIVE]
    return ((c.op_latency_s, c.dcn_bytes_per_byte, c.switch_blip_s),
            (plain.op_latency_s, plain.dcn_bytes_per_byte, plain.switch_blip_s),
            [C.utility(m, snapshot={"ops_per_s": r, "bytes_per_s": 0.0}) for r in (1.0, 1e3)],
            [C.utility(x, C.BYTES_FIRST) for x in (fat, lean)],
            [C.utility(x, o, snap) for o in objectives for x in (slow_cheap, fast_fat)])


def scored_picks(C):
    def mk(name, lat, ratio):
        return impl(C, name, lat=lat, ratio=ratio, caps=C.CapabilitySet.exact(f"wire:{name}"))

    def sel():
        return C.make_stack(C.Select(mk("Legacy", 5e-3, 1.0), mk("ZipWire", 3e-3, 0.25),
                                     mk("FastPath", 4e-4, 1.0)))

    server, offer = sel(), sel().offer()
    picks = [C.pick_compatible(server, offer, mode="first")]
    for snap, obj in (({"ops_per_s": 2000.0, "bytes_per_s": 5e4}, C.LATENCY_FIRST),
                      ({"ops_per_s": 5.0, "bytes_per_s": 5e7}, C.BYTES_FIRST),
                      ({"ops_per_s": 50.0, "bytes_per_s": 5e5}, C.DEFAULT_OBJECTIVE)):
        picks.append(C.pick_compatible(server, offer, snapshot=snap, objective=obj))
    a, b = C.FnChunnel(fn_name="A", caps=C.CapabilitySet.exact("wire:obj")), \
        C.FnChunnel(fn_name="B", caps=C.CapabilitySet.exact("wire:obj"))
    picks.append(C.pick_compatible(C.make_stack(C.Select(a, b)),
                                   C.make_stack(C.Select(b, a)).offer(),
                                   snapshot={"ops_per_s": 1e4, "bytes_per_s": 1e7}))
    only = impl(C, "Only", lat=1.0, ratio=2.0, blip=3.0)
    picks.append(C.pick_compatible(C.make_stack(only), C.make_stack(only).offer(),
                                   snapshot={"ops_per_s": 1e6, "bytes_per_s": 1e9}))
    none = C.pick_compatible(C.make_stack(impl(C, "A", caps=C.CapabilitySet.exact("fmt:a"))),
                             C.make_stack(impl(C, "B", caps=C.CapabilitySet.exact("fmt:b"))).offer())
    scores = [C.score_stack(o, C.LATENCY_FIRST, {"ops_per_s": 10.0}) for o in server.options()]
    return [(p[0].chunnels[0].name, p[1]) for p in picks], none, scores


def scored_targets(C):
    cands = [C.Candidate("fat", C.CostModel(dcn_bytes_per_byte=1.0), "fat"),
             C.Candidate("lean", C.CostModel(dcn_bytes_per_byte=0.1), "lean")]
    near = [C.Candidate("a", C.CostModel(op_latency_s=1.00e-3), "a"),
            C.Candidate("b", C.CostModel(op_latency_s=0.99e-3), "b")]
    out = [C.ScoredTarget(cands, C.BYTES_FIRST).resolve({"bytes_per_s": 1e7}, "fat"),
           C.ScoredTarget(near, C.LATENCY_FIRST, margin=0.5).resolve({"ops_per_s": 100.0},
                                                                     current_label="a"),
           C.ScoredTarget(near, C.LATENCY_FIRST, margin=0.5).resolve({"ops_per_s": 100.0})]
    ab = [C.Candidate("A", C.CostModel(op_latency_s=5e-3), "A"),
          C.Candidate("B", C.CostModel(op_latency_s=1e-4), "B")]
    committed, cur = [], {"v": "A"}

    def switch(t):
        committed.append(t)
        cur["v"] = t
        return True

    ctl = C.ReconfigController(
        [C.Rule("lat", lambda s: True, C.ScoredTarget(ab, C.LATENCY_FIRST), hold=1)],
        switch, lambda: cur["v"], cooldown_s=0.0, now=FakeClock())
    ticks = [ctl.tick({"ops_per_s": 1000.0}).to_json() for _ in range(2)]
    return out, ticks, committed


def test_cost_and_scoring_equal(on_both):
    on_both(cost_values)
    picks, none, _ = on_both(scored_picks)
    assert [p[0] for p in picks[:3]] == ["Legacy", "FastPath", "ZipWire"] and none is None
    out, _, committed = on_both(scored_targets)
    assert out == ["lean", "a", "b"] and committed == ["B"]


# -- the policy registry and the policy path ------------------------------------


def policy_outcomes(C):
    names = [n for n in ("cost_aware", "latency_slo", "byte_budget") if n in C.available_policies()]
    ctx = C.PolicyContext(candidates=[C.Candidate("a"), C.Candidate("b")])
    cost_aware = [(r.name, type(r.target).__name__, r.hold, r.priority)
                  for r in C.policy_rules("cost_aware", ctx)]
    slo_ctx = C.PolicyContext(candidates=[C.Candidate("a")], params={"slo_s": 0.1}, default="a")
    slo = sorted((r.name, r.hold, r.priority) for r in C.policy_rules("latency_slo", slo_ctx))
    bb_ctx = C.PolicyContext(
        candidates=[C.Candidate("fat", C.CostModel(dcn_bytes_per_byte=1.0), "fat"),
                    C.Candidate("lean", C.CostModel(dcn_bytes_per_byte=0.1), "lean")],
        default="fat", params={"bytes_per_s": 1000.0, "hold": 1})
    committed, cur = [], {"v": "fat"}

    def switch(t):
        committed.append(t)
        cur["v"] = t
        return True

    ctl = C.ReconfigController(C.policy_rules("byte_budget", bb_ctx), switch,
                               lambda: cur["v"], cooldown_s=0.0, now=FakeClock())
    ticks = [ctl.tick({"bytes_per_s": b}).to_json() for b in (5000.0, 10.0, 10.0)]
    try:
        C.get_policy("no_such_policy")
    except KeyError as e:
        unknown = "cost_aware" in str(e)
    return names, cost_aware, slo, ticks, committed, unknown


def cost_aware_path(C):
    fabric = C.Fabric()
    ep = fabric.register("pol-ep")
    fast = C.FnChunnel(fn_name="FastPath", upper=C.WireType.of("bytes"),
                       lower=C.WireType.of("bytes"), cost=C.CostModel(op_latency_s=1e-4))
    slow = C.FnChunnel(fn_name="SlowPath", upper=C.WireType.of("bytes"),
                       lower=C.WireType.of("bytes"), cost=C.CostModel(op_latency_s=5e-3))
    stack = C.make_stack(C.Select(slow, fast), C.FabricTransport(ep, "sink"))
    handle = C.LockedConn(stack.preferred())
    errors = []
    for args, kw in (((), {}), (([C.Rule("r", lambda s: True, "X")],), {"policy": "cost_aware"})):
        try:
            C.conn_controller(handle, stack, *args, **kw)
        except ValueError as e:
            errors.append("exactly one" in str(e))
    ctl = C.conn_controller(handle, stack, policy="cost_aware",
                            policy_params={"hold": 1, "margin": 0.0}, cooldown_s=0.0)
    for _ in range(300):
        handle.send([b"x"])
    d = ctl.tick(handle.telemetry.snapshot())
    return errors, d.committed, d.target, handle.stack.chunnels[0].name


def negotiator_picks(C):
    legacy, fast = impl(C, "Legacy", lat=5e-3), impl(C, "FastPath", lat=4e-4)
    tel = C.ConnTelemetry()
    for _ in range(50):
        tel.record_send(1, 100, 0.001)
    out = []
    for neg, (a, b) in ((C.ServerNegotiator(C.make_stack(C.Select(legacy, fast)),
                                            objective=C.LATENCY_FIRST, telemetry=tel),
                         (legacy, fast)),
                        (C.ServerNegotiator(C.make_stack(C.Select(
                            impl(C, "SlowDefault", lat=2.4e-3), impl(C, "FastAlt", lat=1.6e-3)))),
                         (impl(C, "SlowDefault", lat=2.4e-3), impl(C, "FastAlt", lat=1.6e-3)))):
        client = C.make_stack(C.Select(a, b))
        reply = neg.handle("cli", {"type": "offer", "options": client.offer(),
                                   "fps": [o.fingerprint() for o in client.options()]})
        out.append((reply["type"], neg.negotiated["cli"].chunnels[0].name))
    return out, tel.snapshot()["ops_per_s"] > 0.0


def test_policies_equal(on_both):
    names, *_, committed, unknown = on_both(policy_outcomes)
    assert names == ["cost_aware", "latency_slo", "byte_budget"]
    assert committed == ["lean", "fat"] and unknown
    errors, committed, target, name = on_both(cost_aware_path)
    assert errors == [True, True] and committed and target.startswith("FastPath")
    assert name == "FastPath"
    assert on_both(negotiator_picks) == ([("accept", "FastPath"), ("accept", "SlowDefault")], True)
