"""The port's framework-free core (``repro_torch.core``) held against the
reference's (``repro.core``) on the scenarios of the reference's tests:
negotiation, reconfiguration, two-phase commit abort safety, rendezvous and
the batched fabric of ``tests/test_core_bertha.py``, and the batched datapath
contract of ``tests/test_comm.py``.

Each scenario is a function of the core module. It runs on both, the port's
outcome must equal the reference's, and both must equal what the reference's
own tests expect.
"""
import threading
import time
from contextlib import contextmanager

import pytest

import repro_torch.core as port_core

ref_core = pytest.importorskip("repro.core")


def on_both(scenario, *args):
    """``scenario(core, *args)`` on the reference core, then on the port's;
    the port must come out as the reference does. Returns the outcome."""
    ref = scenario(ref_core, *args)
    port = scenario(port_core, *args)
    assert port == ref
    return port


def T(C, name, upper="obj", lower="unit", cap=None):
    return C.FnChunnel(fn_name=name, upper=C.WireType.of(upper),
                       lower=C.WireType.of(lower),
                       caps=C.CapabilitySet.exact(cap) if cap else None)


KAFKA = ("Kafka", "pubsub:kafka")
SQS = ("SQS", "pubsub:sqs")


def stack_of(C, *names_caps):
    chans = [T(C, n, cap=c) for n, c in names_caps]
    return C.make_stack(C.Select(*chans) if len(chans) > 1 else chans[0])


@contextmanager
def agents(C, **fabric_kw):
    fabric = C.Fabric(**fabric_kw)
    srv, cli = C.HostAgent(fabric, "srv"), C.HostAgent(fabric, "cli")
    try:
        yield srv, cli
    finally:
        srv.close()
        cli.close()


def negotiate(C, server, client):
    with agents(C) as (srv, cli):
        srv.listen(stack_of(C, *server))
        try:
            conn = cli.connect("srv", stack_of(C, *client))
        except C.NegotiationError:
            return None
        return conn.stack.chunnels[0].name, srv.accept_stack("cli").chunnels[0].name


def negotiate_lossy(C):
    with agents(C, default_link=C.LinkModel(latency_s=0.001, loss=0.3), seed=7) as (srv, cli):
        st = stack_of(C, ("X", "x"))
        srv.listen(st)
        return cli.connect("srv", st).stack.chunnels[0].name


def zero_rtt_resume(C):
    with agents(C) as (srv, cli):
        st = stack_of(C, ("X", "x"))
        srv.listen(st)
        c1 = cli.connect("srv", st, use_zero_rtt=True)
        c2 = cli.connect("srv", st, use_zero_rtt=True)
        return (c1.was_zero_rtt, c2.was_zero_rtt,
                c2.stack.fingerprint() == c1.stack.fingerprint(), c2.nonce == c1.nonce)


def zero_rtt_claim(C, peer, fp):
    st = stack_of(C, ("X", "x"))
    neg = C.ServerNegotiator(st)
    accept = neg.handle("cli", {"type": "offer", "options": st.offer(),
                                "fps": [o.fingerprint() for o in st.options()]})
    r = neg.handle(peer, {"type": "zero_rtt", "fp": fp or st.preferred().fingerprint()})
    return accept["type"], r["type"], r.get("nonce") == accept["nonce"]


class TestNegotiation:
    @pytest.mark.parametrize("server,client,want", [
        ([KAFKA, SQS], [SQS], "SQS"),            # one RTT, only common option
        ([KAFKA, SQS], [SQS, KAFKA], "Kafka"),   # server preference wins
        ([("A", "fmt:a")], [("B", "fmt:b")], None),  # incompatible: rejected
    ], ids=["one_rtt", "server_preference", "incompatible"])
    def test_outcome(self, server, client, want):
        assert on_both(negotiate, server, client) == (None if want is None else (want, want))

    def test_over_lossy_base_connection(self):
        assert on_both(negotiate_lossy) == "X"

    def test_zero_rtt_resumes_with_the_same_stack_and_nonce(self):
        assert on_both(zero_rtt_resume) == (False, True, True, True)

    @pytest.mark.parametrize("peer,fp,want", [
        ("stranger", "anything", "negotiate_failed"),
        ("cli", "not-what-we-agreed", "negotiate_failed"),
        ("cli", None, "zero_rtt_ok"),
    ], ids=["unknown_peer", "wrong_fp", "agreed_fp"])
    def test_zero_rtt_claim_validated_against_cache(self, peer, fp, want):
        assert on_both(zero_rtt_claim, peer, fp) == ("accept", want, want == "zero_rtt_ok")


def counting(C, name):
    calls = {"n": 0}

    def on_send(m):
        calls["n"] += 1
        return m

    return C.FnChunnel(fn_name=name, on_send=on_send), calls


def echo_stack(C, fabric, name):
    ep = fabric.register(f"ep-{name}-{time.monotonic_ns()}")
    ch, calls = counting(C, name)
    return C.make_stack(ch, C.FabricTransport(ep, "nowhere")), calls


def unilateral_swap(C, cls_name):
    fabric = C.Fabric()
    st_a, calls_a = echo_stack(C, fabric, "A")
    st_b, calls_b = echo_stack(C, fabric, "B")
    cls = getattr(C, cls_name)
    handle = cls(st_a.preferred()) if cls_name == "LockedConn" else cls(
        st_a.preferred(), n_threads=1)
    stop = threading.Event()
    sent = {"n": 0}

    def pump():
        while not stop.is_set():
            handle.send([b"x"])
            sent["n"] += 1

    t = threading.Thread(target=pump)
    t.start()
    time.sleep(0.05)
    ok = handle.reconfigure(st_b.preferred())
    time.sleep(0.05)
    stop.set()
    t.join(timeout=5)
    return (t.is_alive(), ok, handle.stats.switches, calls_a["n"] > 0, calls_b["n"] > 0,
            sent["n"] == calls_a["n"] + calls_b["n"])


def coordinate_false(C):
    fabric = C.Fabric()
    st_a, _ = echo_stack(C, fabric, "A")
    st_b, _ = echo_stack(C, fabric, "B")
    handle = C.LockedConn(st_a.preferred())
    ok = handle.reconfigure(st_b.preferred(), coordinate=lambda: False)
    return ok, handle.stack.chunnels[0].name


class TestReconfiguration:
    @pytest.mark.parametrize("cls", ["LockedConn", "BarrierConn"])
    def test_unilateral_swap_preserves_service(self, cls):
        assert on_both(unilateral_swap, cls) == (False, True, 1, True, True, True)

    def test_coordinate_false_aborts(self):
        assert on_both(coordinate_false) == (False, "A")


def two_phase(C, faults):
    sent = []
    commit_timeout = faults.get("commit_timeout", ())
    refuse = faults.get("refuse", ())
    abort_timeout = faults.get("abort_timeout", ())

    def request(p, m):
        t = m["type"]
        sent.append((p, t))
        if t == "reconfig_prepare":
            return {"type": "reconfig_refuse" if p in refuse else "reconfig_ready"}
        if (t == "reconfig_commit" and p in commit_timeout) or (
                t == "reconfig_abort" and p in abort_timeout):
            raise TimeoutError(p)
        return {"type": "reconfig_done"}

    ok = C.reconfigure.two_phase_commit(request, ["p1", "p2", "p3"], "fp-new")
    return (ok, [p for p, t in sent if t == "reconfig_commit"],
            [p for p, t in sent if t == "reconfig_abort"])


class TestTwoPhaseCommitAbortSafety:
    @pytest.mark.parametrize("faults,ok,commits,aborts", [
        ({"commit_timeout": {"p2"}}, True, ["p1", "p2", "p3"], []),
        ({"refuse": {"p3"}, "abort_timeout": {"p1"}}, False, [], ["p1", "p2"]),
    ], ids=["commit_timeout_does_not_escape", "refusal_aborts_timeout_swallowed"])
    def test_outcome(self, faults, ok, commits, aborts):
        assert on_both(two_phase, faults) == (ok, commits, aborts)


A_DESC = [[{"name": "A", "caps": []}]]


def first_proposer(C):
    rv, store = C.rendezvous, C.KVStore()
    r1 = rv.join(store, "conn", "m1", ["fpA"], A_DESC, lambda d: 0)
    r2 = rv.join(store, "conn", "m2", ["fpB", "fpA"],
                 [[{"name": "B", "caps": []}], A_DESC[0]], lambda d: 1)
    return r1.proposed, r1.stack_fp, r2.proposed, r2.stack_fp, r2.participants


def incompatible_joiner(C):
    rv, store = C.rendezvous, C.KVStore()
    rv.join(store, "conn", "m1", ["fpA"], A_DESC, lambda d: 0)
    try:
        rv.join(store, "conn", "m2", ["fpB"], [[{"name": "B", "caps": []}]], lambda d: None)
    except ValueError:
        return "ValueError"
    return "joined"


def late_joiner(C):
    rv, store = C.rendezvous, C.KVStore()
    rv.join(store, "conn", "m1", ["fpA"], A_DESC, lambda d: 0)
    cur = rv.current_stack(store, "conn")
    return cur["fp"], cur["epoch"]


def transition(C, votes, aged):
    rv, store = C.rendezvous, C.KVStore()
    for m in ("m1", "m2", "m3"):
        rv.join(store, "conn", m, ["fpA"], A_DESC, lambda d: 0)
    epoch = rv.propose_transition(store, "conn", "m1", "fpB", [{"name": "B", "caps": []}])
    pending = rv.try_commit(store, "conn", epoch, 5.0)
    for m, v in votes.items():
        rv.vote(store, "conn", m, epoch, v)
    t0 = time.monotonic() - 10.0 if aged else None
    done = rv.try_commit(store, "conn", epoch, 5.0, t0)
    return pending, done, rv.current_stack(store, "conn")["fp"]


class TestRendezvous:
    def test_first_proposer_wins_cas(self):
        assert on_both(first_proposer) == (True, "fpA", False, "fpA", 2)

    def test_incompatible_joiner_raises(self):
        assert on_both(incompatible_joiner) == "ValueError"

    def test_late_joiner_recovers_stack(self):
        assert on_both(late_joiner) == ("fpA", 1)

    @pytest.mark.parametrize("votes,aged,want,fp", [
        ({"m2": True, "m3": True}, False, True, "fpB"),
        ({"m2": False}, False, False, "fpA"),
        ({}, True, False, "fpA"),
    ], ids=["all_ack_commits", "any_refusal_aborts", "timeout_aborts"])
    def test_transition(self, votes, aged, want, fp):
        assert on_both(transition, votes, aged) == (None, want, fp)  # None: pending


def recv_until(ep, n, timeout=2.0):
    buf, got = [None] * max(n, 1), []
    deadline = time.monotonic() + timeout
    while len(got) < n and time.monotonic() < deadline:
        k = ep.recv_many(buf, timeout=0.1)
        got.extend(buf[:k])
    return got


def order_and_drain(C):
    fabric = C.Fabric()
    a, b = fabric.register("bf-a"), fabric.register("bf-b")
    msgs = [f"m{i}".encode() for i in range(100)]
    a.send_batch("bf-b", msgs)
    got = recv_until(b, 100)
    return ([m for _, m in got] == msgs, all(s == "bf-a" for s, _ in got),
            b.recv_many([None] * 100, timeout=0.0))


def max_n(C):
    fabric = C.Fabric()
    a, b = fabric.register("mx-a"), fabric.register("mx-b")
    a.send_batch("mx-b", [b"x"] * 10)
    buf = [None] * 10
    return b.recv_many(buf, max_n=3, timeout=0.1), b.recv_many(buf, max_n=100, timeout=0.5)


def split_counters(C):
    fabric = C.Fabric(default_link=C.LinkModel(loss=0.5), seed=3)
    a = fabric.register("sc-a")
    fabric.register("sc-b")
    a.send_batch("sc-b", [b"p" * 8] * 200)
    a.send_batch("ghost", [b"q" * 8] * 10)
    return fabric.counters.snapshot()


def per_message_loss(C):
    fabric = C.Fabric(default_link=C.LinkModel(loss=0.3), seed=11)
    a, b = fabric.register("pm-a"), fabric.register("pm-b")
    a.send_batch("pm-b", [bytes([i]) for i in range(200)])
    return len(recv_until(b, 200, timeout=0.5))


class TestBatchedFabric:
    def test_recv_many_order_and_drain(self):
        assert on_both(order_and_drain) == (True, True, 0)

    def test_recv_many_respects_max_n(self):
        assert on_both(max_n) == (3, 7)

    def test_split_counters_loss_and_unroutable(self):
        c = on_both(split_counters)  # the same seed drops the same datagrams
        assert c["sent"] == 210 and c["dropped_unroutable"] == 10
        assert 0 < c["dropped_loss"] < 200
        assert c["delivered"] == 200 - c["dropped_loss"]
        assert c["sent_bytes"] == 210 * 8

    def test_batch_loss_is_per_message(self):
        assert 0 < on_both(per_message_loss) < 200


def fabric_pair(C, chunnel=None):
    fab = C.Fabric()
    a, b = fab.register("pair-a"), fab.register("pair-b")
    tx = C.FabricTransport(a, "pair-b").connect_wrap(None)
    rx = C.FabricTransport(b, "pair-a").connect_wrap(None)
    if chunnel is not None:
        tx, rx = chunnel.connect_wrap(tx), chunnel.connect_wrap(rx)
    return tx, rx


def drain(rx, n, timeout=2.0):
    buf, got = [None] * max(n, 1), []
    deadline = time.monotonic() + timeout
    while len(got) < n and time.monotonic() < deadline:
        k = rx.recv(buf, timeout=0.1)
        got.extend(buf[:k])
    return got


def datapath_contract(C, kind, n):
    seen = []

    def send_batch(msgs):
        seen.append(len(msgs))
        return [m + b"!" for m in msgs]

    chunnel = {
        "transport": None,
        "per_message": C.FnChunnel(fn_name="Rev", on_send=lambda m: m[::-1],
                                   on_recv=lambda m: m[::-1]),
        "batch": C.FnChunnel(fn_name="Batch", on_send_batch=send_batch,
                             on_recv_batch=lambda msgs: [m[:-1] for m in msgs]),
    }[kind]
    tx, rx = fabric_pair(C, chunnel)
    msgs = [f"m-{i}".encode() for i in range(n)]
    tx.send(msgs)
    return drain(rx, n) == msgs, seen


class TestBatchedDatapathContract:
    """send(msgs)/recv(buf) preserves order, count and content for batch
    sizes 0/1/odd/large, with one transform call per batch."""

    BATCHES = [0, 1, 3, 7, 64, 257]

    @pytest.mark.parametrize("kind", ["transport", "per_message", "batch"])
    @pytest.mark.parametrize("n", BATCHES)
    def test_contract(self, kind, n):
        ok, seen = on_both(datapath_contract, kind, n)
        assert ok
        if kind == "batch":
            assert seen == [n]
