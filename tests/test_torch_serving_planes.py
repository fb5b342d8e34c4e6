"""The port's serving planes held against the reference's: pub/sub with its
two orderings, the sharded key-value router and its two load policies, and
the region gateway behind the WAN link.

Each scenario is a function of one package's modules. It runs on the
reference and on the port, and the two outcomes must be equal. Pub/sub, the
key-value store and the gateway deliver through timer and server threads, so
their scenarios return what does not depend on the clock: what each
subscriber received in each ordering group, where each key landed, every
reply, the gateway's counts (not its duplicate replies, which follow the
sender's retransmit timer).

A broker delivers each published batch from a timer thread of its own, so on
both packages two batches published back to back can arrive swapped even
from a broker whose model is ordered: with service-side ordering the test
compares what each group received as a set; receive-side ordering must give
every group in order.
"""
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch


def _port():
    import repro_torch.comm.chunnels as chunnels
    import repro_torch.core as core
    import repro_torch.serving.gateway as gateway
    import repro_torch.serving.pubsub as pubsub
    import repro_torch.serving.router as router
    return SimpleNamespace(
        core=core, pubsub=pubsub, router=router,
        gateway=lambda fabric, addr: gateway.WanGateway(fabric, addr, device="cpu"),
        wanlink=lambda ep, peer, **kw: chunnels.WanLinkChunnel(ep, peer, device="cpu", **kw))


PORT = _port()


@pytest.fixture(scope="module")
def REF():
    pytest.importorskip("jax")
    import repro.comm.chunnels as chunnels
    import repro.core as core
    import repro.serving.gateway as gateway
    import repro.serving.pubsub as pubsub
    import repro.serving.router as router
    return SimpleNamespace(
        core=core, pubsub=pubsub, router=router,
        gateway=lambda fabric, addr: gateway.WanGateway(fabric, addr, use_kernel=False),
        wanlink=lambda ep, peer, **kw: chunnels.WanLinkChunnel(ep, peer, use_kernel=False, **kw))


@pytest.fixture
def on_both(REF):
    def run(scenario, *args):
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


def describe(stack):
    return [(ch.name, sorted(str(c) for c in ch.capabilities())) for ch in stack.chunnels]


# -- pub/sub --------------------------------------------------------------------


def pubsub_run(P, model, ordering):
    """60 messages in 2 ordering groups, published in batches of 10 through
    one connection and received through another."""
    C, PS = P.core, P.pubsub
    broker = PS.Broker(getattr(PS, model), seed=5)

    def conn():
        order = PS.ServiceOrdering() if ordering == "service" else PS.ReceiveSideOrdering(groups=2)
        return C.LockedConn(C.make_stack(order, PS.PubSubChunnel(broker, "t")).preferred())

    rx, tx = conn(), conn()
    msgs = [{"group": i % 2, "i": i} for i in range(60)]
    for k in range(0, 60, 10):
        tx.send(msgs[k:k + 10])
    got, buf = [], [None] * 16
    deadline = time.monotonic() + 5.0
    while len(got) < 60 and time.monotonic() < deadline:
        n = rx.recv(buf, timeout=0.05)
        got.extend(buf[:n])
    groups = {g: [m["i"] for m in got if m["group"] == g] for g in (0, 1)}
    if ordering == "service":
        groups = {g: sorted(v) for g, v in groups.items()}
    keys = sorted({k for m in got for k in m})
    return (describe(rx.stack), groups, keys, broker.published, broker.cost,
            broker.n_subscribers("t"), broker._rng.random())


@pytest.mark.parametrize("model,ordering", [("KAFKA", "service"), ("SQS_ORDERED", "service"),
                                            ("SQS_BEST_EFFORT", "receive")])
def test_pubsub_orderings_equal(on_both, model, ordering):
    _, groups, *_ = on_both(pubsub_run, model, ordering)
    assert groups == {g: list(range(g, 60, 2)) for g in (0, 1)}  # each once, none lost


# -- the key-value router ------------------------------------------------------------


def shards(P):
    keys = [f"user:{i}" for i in range(200)] + ["", "k", "ключ"]
    return [P.router.shard_of(k, n) for k in keys for n in (1, 3, 8)]


def routed_batch(P, n):
    """``tests/test_comm.py``'s ClientShard case: a batch is routed in one
    inner send, every message annotated with its backend."""
    C, R = P.core, P.router
    calls = []

    class Sink(C.Datapath):
        def send(self, msgs):
            calls.append(list(msgs))

        def recv(self, buf, timeout=None):
            return 0

    dp = R.ClientShardChunnel(backends=("s0", "s1", "s2")).connect_wrap(Sink())
    dp.send([{"key": f"k{i}"} for i in range(n)])
    sr = R.ServerRouterChunnel(router_addr="rt").connect_wrap(Sink())
    sr.send([{"key": f"k{i}"} for i in range(n)])
    return calls


def kv_run(P):
    """PUTs through the router, a switch to client-side sharding, GETs
    direct to the owning backends."""
    C, R = P.core, P.router
    fabric = C.Fabric()
    backends = [R.KVBackend(fabric, f"b{i}") for i in range(3)]
    router = R.Router(fabric, "router", [b.addr for b in backends])
    ep = fabric.register("cli")
    stack = R.routing_stack(ep, [b.addr for b in backends], "router", prefer="server")
    handle = C.LockedConn(stack.preferred())
    client = R.KVClient(fabric, ep, handle)
    try:
        first = describe(handle.stack)
        puts = [client.request("put", f"k{i}", i)[0] for i in range(24)]
        handle.reconfigure(C.option_named(stack, "ClientShard"))
        gets = [client.request("get", f"k{i}")[0] for i in range(24)]
        return (first, describe(handle.stack), puts, gets,
                [sorted(b.data.items()) for b in backends], fabric.counters.snapshot()["sent"])
    finally:
        router.close()
        for b in backends:
            b.close()


def test_shard_of_equal(on_both):
    on_both(shards)


@pytest.mark.parametrize("n", [1, 7, 64])
def test_routed_batch_is_one_inner_send_equal(on_both, n):
    calls = on_both(routed_batch, n)
    assert [len(c) for c in calls] == [n, n]
    assert all("_route_to" in m for c in calls for m in c)


def test_kv_router_equal(on_both):
    first, then, puts, gets, placement, _ = on_both(kv_run)
    assert first[0][0] == "ServerRouter" and then[0][0] == "ClientShard"
    assert [g["val"] for g in gets] == list(range(24))
    assert sum(len(p) for p in placement) == 24


#: (policy, params, scripted snapshots)
KV_POLICY_CASES = [
    ("kv_load_adaptive", {},
     [{"ops_per_s": v} for v in (100, 200, 200, 200, 130, 100, 100, 100, 160)]),
    ("kv_load_adaptive", {"high_ops_per_s": 50.0, "low_ops_per_s": 10.0, "hold": 1},
     [{"ops_per_s": v} for v in (60, 5, 60, 30, 5)]),
    ("kv_fleet_adaptive", {},
     [{"fleet.offered_qps": v} for v in (100, 250, 250, 250, 110, 110, 300)]),
    ("kv_fleet_adaptive", {"spot_cap_usd_per_h": 2.0, "hold": 1},
     [{"fleet.offered_qps": q, "ext.spot_usd_per_h": s}
      for q, s in ((250, 1.0), (150, 3.0), (150, 3.0), (250, 3.0), (150, 1.0))]),
    ("kv_fleet_adaptive", {"slo": "kv_p95", "hold": 2},
     [{"fleet.offered_qps": q, "slo.kv_p95.alarm": a}
      for q, a in ((150, 0.0), (150, 1.0), (100, 1.0), (100, 0.0), (100, 0.0))]),
]


def kv_policy_decisions(P, policy, params, stream):
    C, R = P.core, P.router
    ep = C.Fabric().register("cli")
    stack = R.routing_stack(ep, ["b0", "b1"], "router", prefer="server")
    handle = C.LockedConn(stack.preferred())
    ctl = C.conn_controller(handle, stack, policy=policy, policy_params=params,
                            cooldown_s=0.0, now=FakeClock())
    rules = [(r.name, r.hold, r.priority) for r in ctl.rules]
    ticks = []
    for snap in stream:
        d = ctl.tick(snap)
        ticks.append((d.rule, d.target, d.fired, d.committed, d.reason,
                      handle.stack.chunnels[0].name))
    return rules, ticks, ctl.counts()


@pytest.mark.parametrize("case", KV_POLICY_CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(KV_POLICY_CASES)])
def test_kv_policy_decisions_equal(on_both, case):
    _, ticks, counts = on_both(kv_policy_decisions, *case)
    assert counts["committed"] >= 1
    assert len(ticks) == len(case[2])


# -- the region gateway -------------------------------------------------------------


def gateway_batches():
    rng = np.random.default_rng(4)
    return [[rng.standard_normal((40, 130)).astype(np.float32), bytes(range(256)) * 9,
             {"rid": 1}],
            [rng.standard_normal(300).astype(np.float32),
             rng.standard_normal((2, 3)).astype(np.float32)],
            [b"tiny"], [{"rid": 2}, "text"]]


def warm_reference_decode():
    """Decode ``gateway_batches``' float runs once through the reference's
    wire, outside any window. The reference's gateway decodes each blob in
    the thread that acks the window, and its first decode of a shape
    compiles: 68 ms on an idle 8-core host and 124-286 ms beside 14 busy
    processes, where the sender's window gives up after 8 rounds of 30 ms
    without an ack; the port's gateway took at most 0.7 ms a frame
    (``scripts/gateway_stall_probe.py``)."""
    from repro.comm import wire

    for batch in gateway_batches():
        floats = [m for m in batch if isinstance(m, np.ndarray)]
        if not floats:
            continue
        reasm = wire.Reassembler()
        for frame in wire.encode_batch(floats, block=64, use_kernel=False, chunk_bytes=1024):
            done = reasm.ingest(frame)
        wire.decode_blob(*done, use_kernel=False)


def gateway_run(P):
    """Mixed batches through the WAN link to a gateway (a float tensor, raw
    bytes larger than the MTU, control objects), a keepalive, and an echo
    on the fast path."""
    C = P.core
    fabric = C.Fabric()
    gw = P.gateway(fabric, "hub")
    dp = P.wanlink(fabric.register("cli/wan"), "hub/wan", mtu_bytes=1024,
                   block=64).connect_wrap(None)
    try:
        for b in gateway_batches():
            dp.send(b)
        pong = dp.ping()
        fast = fabric.register("cli/fast")
        fast.send("hub/fast", {"rid": 9})
        echo = fast.recv(timeout=2.0)
        timed = ("dup_replies", "retransmits", "retransmit_ratio")
        return ({k: v for k, v in gw.stats().items() if k not in timed},
                {k: v for k, v in dp.stats().items() if k not in timed}, pong, echo)
    finally:
        gw.close()


def test_gateway_counts_equal(on_both):
    warm_reference_decode()
    gw, link, pong, echo = on_both(gateway_run)
    assert gw["wan_blobs"] == 4      # the first batch's tensors, raw bytes; then 2 more
    assert gw["wan_msgs"] == 8 and gw["wan_pings"] == 1 and gw["fast_msgs"] == 1
    assert pong and echo == ("hub/fast", {"rid": 9})


def test_gateway_counts_torch_tensors_as_numpy():
    """On the port, torch float tensors count as the same blobs and messages
    as numpy arrays of the same shapes."""
    C = PORT.core
    out = []
    for as_torch in (False, True):
        fabric = C.Fabric()
        gw = PORT.gateway(fabric, "hub")
        dp = PORT.wanlink(fabric.register("cli/wan"), "hub/wan", mtu_bytes=1024,
                          block=64).connect_wrap(None)
        xs = [np.full((40, 130), 0.5, np.float32), np.arange(300, dtype=np.float32)]
        if as_torch:
            xs = [torch.from_numpy(x) for x in xs]
        try:
            dp.send([xs[0], b"raw", xs[1]])
            out.append((gw.stats()["wan_blobs"], gw.stats()["wan_msgs"], dp.frames_sent))
        finally:
            gw.close()
    assert out[0] == out[1] == (3, 3, out[0][2]) and out[0][2] > 3
