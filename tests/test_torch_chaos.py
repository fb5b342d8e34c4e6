"""The port's chaos injector and WAN link held against the reference's.

- The reference's classes of ``tests/test_chaos.py`` run on ``repro_torch``
  (``port_mirror``), the WAN link on ``device="cpu"`` where the reference
  passes ``use_kernel=False``.
- A fault schedule on a virtual clock and a seeded lossy fabric give the same
  event log, links and deliveries on both packages.
- The WAN link's frames for one batch equal the reference's byte for byte
  and header for header (the blob id and trace ctx aside), and a torch float
  tensor rides the int8 wire rather than the fabric whole.
- The chaos-regions scenario meets the reference's WAN and DCN acceptance
  predicates on the port (``torch_chaos_regions``) and on the reference
  (``benchmarks/bench_reconfigure.py``). It runs on the real clock, so the
  two runs are held to the predicates, not to each other.
"""
import threading
import time

import numpy as np
import pytest
import torch

from port_mirror import CPU_WIRE, mirror
from repro_torch.chaos import ChaosInjector, ChaosPlan, VirtualClock
from repro_torch.comm.chunnels import WanLinkChunnel, _is_float_tensor
from repro_torch.core.fabric import Fabric, LinkModel
from repro_torch.kernels.quantize.quantize import quantize_pack_ref, unpack_dequant_ref
from torch_chaos_regions import assert_regions_acceptance, run_chaos_regions


@pytest.fixture
def seeded_fabric():
    """The port's counterpart of the reference's fixture: a seeded fabric,
    zero-latency unless told otherwise."""

    def make(seed: int = 0, *, default_link: LinkModel = None, **kw) -> Fabric:
        return Fabric(default_link=default_link or LinkModel(), seed=seed, **kw)

    return make


@pytest.fixture
def virtual_clock():
    return VirtualClock(0.0)


globals().update(mirror("test_chaos.py", [
    "TestLinkModelEdges", "TestRecvMany", "TestReliableUnderLoss", "TestChaosInjector",
    "TestWanLink", "TestPartitionRegressions"], edits=CPU_WIRE[:1]))


@pytest.fixture(scope="module")
def ref():
    pytest.importorskip("jax")
    import repro.chaos as chaos
    import repro.comm.chunnels as chunnels
    import repro.core.fabric as fabric
    return {"chaos": chaos, "fabric": fabric, "chunnels": chunnels}


def port():
    import repro_torch.chaos as chaos
    import repro_torch.comm.chunnels as chunnels
    import repro_torch.core.fabric as fabric
    return {"chaos": chaos, "fabric": fabric, "chunnels": chunnels}


def links(f, pairs):
    return [(lambda m: (m.latency_s, m.jitter_s, m.loss))(f.get_link(a, b)) for a, b in pairs]


def fault_schedule(P):
    """A plan of every event kind, polled on a virtual clock, with seeded
    lossy traffic between the polls: the injector's log, the links after
    each poll, and what was delivered."""
    F, X = P["fabric"], P["chaos"]
    f = F.Fabric(default_link=F.LinkModel(), seed=11)
    eps = {addr: f.register(addr) for addr in ("a", "b", "n", "n/ctrl", "m1", "m2", "m3")}
    plan = X.ChaosPlan(seed=3)
    plan.degrade("a", "b", F.LinkModel(latency_s=0.0, loss=0.4), at=0.5, label="w")
    plan.partition("a", "b", at=1.0, label="cut")
    plan.heal("cut", at=2.0)
    plan.crash("n", at=1.5, for_s=1.0, label="boom")
    plan.partition("a", "m1", on="go", label="trig")
    churn = plan.churn(["m1", "m2", "m3"], start_s=0.0, period_s=1.0, down_s=0.4, rounds=4)
    clock = X.VirtualClock(0.0)
    inj = X.ChaosInjector(f, plan).start(now=clock())
    pairs = [("a", "b"), ("b", "a"), ("n/ctrl", "a"), ("a", "n"), ("m1", "m2"), ("a", "m1")]
    trace = []
    for step in range(8):
        applied = inj.poll(now=clock.advance(0.45))
        if step == 3:
            applied += inj.fire("go")
        sent = eps["a"].send_batch("b", [f"m{step}-{i}" for i in range(16)])
        trace.append((applied, links(f, pairs), sent, sorted(inj.active_labels())))
    f.register("n/new")
    trace.append(links(f, [("n/new", "a")]))
    inj.stop()
    trace.append(links(f, pairs))
    buf = [None] * 256
    got = eps["b"].recv_many(buf, timeout=0.0)
    c = f.counters.snapshot()
    # a fired trigger is stamped from the real clock
    log = [{**e, "t_s": None} if e["label"] == "trig" else e for e in inj.log]
    return churn, log, trace, [m for _, m in buf[:got]], c


def test_fault_schedule_equal(ref):
    want = fault_schedule(ref)
    got = fault_schedule(port())
    assert got == want
    assert got[2][-1] == [(0.0, 0.0, 0.0)] * 6  # stop() healed everything


# -- the WAN link's frames and the float-tensor guard ------------------------------


class _Recorder:
    """Stands in for the datapath's reliable channel: keeps every window."""

    def __init__(self):
        self.windows = []

    def request_window(self, frames):
        self.windows.append(list(frames))


def wan_frames(make_dp, batch):
    dp = make_dp()
    rec = _Recorder()
    dp._chan = rec
    dp.send(batch)
    (frames,) = rec.windows
    out = []
    for fr in frames:
        if "_wire" in fr:
            hdr = None if fr["hdr"] is None else {k: v for k, v in fr["hdr"].items() if k != "tc"}
            out.append(("wire", fr["_wire"][1:], hdr, bytes(fr["data"])))
        else:
            out.append(("obj", fr["_obj"]))
    return out, dp.frames_sent


def mixed_batch(seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((40, 130)).astype(np.float32) * 3.0,
            rng.standard_normal(1001).astype(np.float32),
            bytes(range(256)) * 9,
            {"kind": "ctrl", "i": 7},
            rng.standard_normal((3, 5, 7)).astype(np.float32),
            (np.arange(64 * 257, dtype=np.float32).reshape(64, 257) - 8000.0)]


@pytest.mark.parametrize("block,mtu", [(64, 1024), (256, 2048), (256, 4096)])
def test_wan_frames_equal_reference(ref, block, mtu):
    batch = mixed_batch(block + mtu)
    f_ref, f_port = ref["fabric"].Fabric(), Fabric()
    want, n_ref = wan_frames(lambda: ref["chunnels"].WanLinkChunnel(
        f_ref.register("wa"), "wb", mtu_bytes=mtu, block=block,
        use_kernel=False).connect_wrap(None), batch)
    got, n_port = wan_frames(lambda: WanLinkChunnel(
        f_port.register("wa"), "wb", mtu_bytes=mtu, block=block,
        device="cpu").connect_wrap(None), batch)
    assert n_port == n_ref == len(got) == len(want) > len(batch)
    assert [g[:3] for g in got] == [w[:3] for w in want]  # kinds, chunk indices, headers
    assert [g[3:] for g in got] == [w[3:] for w in want]  # payload bytes, objects


def test_is_float_tensor_guard():
    assert _is_float_tensor(torch.ones(3))
    assert _is_float_tensor(torch.ones(3, dtype=torch.bfloat16))
    assert _is_float_tensor(np.ones(3, dtype=np.float32))
    assert not _is_float_tensor(torch.ones(3, dtype=torch.int32))
    assert not _is_float_tensor(np.ones(3, dtype=np.int64))
    assert not _is_float_tensor({"dtype": "x"})
    assert not _is_float_tensor(b"bytes")


def test_torch_tensor_rides_the_int8_wire(seeded_fabric):
    """A torch float32 tensor sent through the WAN link arrives as a new
    float32 tensor, the int8 round trip of what was sent, in more than one
    frame when the blob is larger than the MTU."""
    f = seeded_fabric()
    epa, epb = f.register("wa"), f.register("wb")
    tx = WanLinkChunnel(epa, "wb", mtu_bytes=1024, block=64, device="cpu").connect_wrap(None)
    rx = WanLinkChunnel(epb, "wa", mtu_bytes=1024, block=64, device="cpu").connect_wrap(None)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((40, 130)).astype(np.float32))
    out = []

    def collect():
        buf = [None]
        deadline = time.monotonic() + 5.0
        while not out and time.monotonic() < deadline:
            if rx.recv(buf, timeout=0.05):
                out.append(buf[0])

    t = threading.Thread(target=collect)
    t.start()
    tx.send([x])
    t.join()
    (y,) = out
    assert isinstance(y, torch.Tensor) and y is not x
    assert y.dtype == torch.float32 and y.shape == x.shape
    assert tx.frames_sent > 1 and x.numel() * 4 > 1024
    flat = torch.nn.functional.pad(x.reshape(-1), (0, (-x.numel()) % 64)).view(-1, 64)
    want = unpack_dequant_ref(quantize_pack_ref(flat), flat.shape[0], 64)[:x.numel()]
    assert torch.equal(y.reshape(-1), want)


def test_wan_link_and_gateway_default_to_cuda():
    """Without a GPU the default device raises at construction."""
    from repro_torch.serving.gateway import WanGateway

    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    f = Fabric()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        WanLinkChunnel(f.register("wa"), "wb")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        WanGateway(f, "hub")


# -- the chaos-regions scenario ----------------------------------------------------


def test_chaos_regions_port_meets_acceptance():
    res = run_chaos_regions(fast=True, device="cpu")
    assert_regions_acceptance(res)
    assert res["gateway"]["wan_blobs"] <= res["wan"]["blobs_sent"]


def test_chaos_regions_reference_meets_acceptance(ref):
    from benchmarks.bench_reconfigure import run_chaos_regions as run_reference

    res = run_reference(fast=True)
    assert_regions_acceptance(res)
