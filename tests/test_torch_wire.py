"""The port's fused compressed wire (``repro_torch.comm.wire``) against the
reference's (``repro.comm.wire``).

Frames must be byte-equal to the reference's for both of its ``use_kernel``
settings, and frames from either package must decode in the other, exactly
(the ``wire:int8-blockq{block}`` capability promises that peers interoperate).
The datapath contract of ``tests/test_comm.py`` is re-run on the port's
``CompressChunnel``. Tests marked ``cuda`` check the one-launch-per-batch
costs on the card and skip without one.
"""
import time

import numpy as np
import pytest
import torch

from repro_torch.comm import wire
from repro_torch.comm.wire import CompressChunnel
from repro_torch.core.fabric import Fabric
from repro_torch.core.runtime import FabricTransport
from repro_torch.kernels.quantize.quantize import quantize_pack, unpack_dequant

# the message shapes of tests/test_comm.py::TestFusedWire
COMM_SHAPES = [(33,), (8, 9), (301,)]


@pytest.fixture(scope="module")
def ref_wire():
    return pytest.importorskip("repro.comm.wire")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def blob(frames):
    return b"".join(f["data"] for f in frames)


def comm_msgs(seed=0, scale=3.0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) * scale for s in COMM_SHAPES]


def bits(a):
    return np.ascontiguousarray(np.asarray(a), dtype=np.float32).view(np.uint32)


def fabric_pair(chunnel):
    fab = Fabric()
    a, b = fab.register("pair-a"), fab.register("pair-b")
    tx = chunnel.connect_wrap(FabricTransport(a, "pair-b").connect_wrap(None))
    rx = chunnel.connect_wrap(FabricTransport(b, "pair-a").connect_wrap(None))
    return tx, rx


def drain(rx, n_expected, timeout=2.0):
    buf = [None] * max(n_expected, 1)
    got = []
    deadline = time.monotonic() + timeout
    while len(got) < n_expected and time.monotonic() < deadline:
        n = rx.recv(buf, timeout=0.1)
        got.extend(buf[:n])
    return got


class TestFramesEqualReference:
    @pytest.mark.parametrize("use_kernel", [True, False])
    @pytest.mark.parametrize("block", [64, 256])
    def test_comm_shapes(self, ref_wire, block, use_kernel):
        msgs = comm_msgs()
        mine = wire.encode_batch(msgs, block=block, device="cpu")
        ref = ref_wire.encode_batch(msgs, block=block, use_kernel=use_kernel)
        assert blob(mine) == blob(ref)
        assert mine[0]["hdr"] == ref[0]["hdr"]
        assert [f["_wire"][1:] for f in mine] == [f["_wire"][1:] for f in ref]

    @pytest.mark.parametrize("use_kernel", [True, False])
    @pytest.mark.parametrize("n_blocks", [1, 3, 8])
    @pytest.mark.parametrize("block", [64, 128, 256])
    def test_fused_wire_path_shapes(self, ref_wire, block, n_blocks, use_kernel):
        """The (n_blocks, block) inputs of tests/test_kernels.py::TestFusedWirePath."""
        rng = np.random.default_rng(block + n_blocks)
        x = rng.standard_normal((n_blocks, block)).astype(np.float32) * 5.0
        mine = wire.encode_batch([x], block=block, device="cpu")
        ref = ref_wire.encode_batch([x], block=block, use_kernel=use_kernel)
        assert blob(mine) == blob(ref)

    def test_torch_and_numpy_messages_give_the_same_frames(self):
        msgs = comm_msgs(seed=4)
        from_numpy = wire.encode_batch(msgs, block=64, device="cpu")
        from_torch = wire.encode_batch([torch.from_numpy(m) for m in msgs],
                                       block=64, device="cpu")
        assert blob(from_numpy) == blob(from_torch)
        assert from_numpy[0]["hdr"] == from_torch[0]["hdr"]


class TestCrossDecode:
    @pytest.mark.parametrize("block", [64, 256])
    def test_port_frames_decode_in_reference(self, ref_wire, block):
        msgs = comm_msgs(seed=1, scale=1e3)
        frames = wire.encode_batch(msgs, block=block, device="cpu")
        mine = wire.decode_blob(blob(frames), frames[0]["hdr"], device="cpu")
        for use_kernel in (True, False):
            theirs = ref_wire.decode_blob(blob(frames), frames[0]["hdr"],
                                          use_kernel=use_kernel)
            for a, b in zip(mine, theirs):
                assert tuple(a.shape) == b.shape
                np.testing.assert_array_equal(bits(a.numpy()), bits(b))

    @pytest.mark.parametrize("use_kernel", [True, False])
    @pytest.mark.parametrize("block", [64, 256])
    def test_reference_frames_decode_in_port(self, ref_wire, block, use_kernel):
        msgs = comm_msgs(seed=2, scale=1e-3)
        frames = ref_wire.encode_batch(msgs, block=block, use_kernel=use_kernel)
        theirs = ref_wire.decode_blob(blob(frames), frames[0]["hdr"])
        mine = wire.decode_blob(blob(frames), frames[0]["hdr"], device="cpu")
        for a, b in zip(mine, theirs):
            assert tuple(a.shape) == b.shape and a.dtype == torch.float32
            np.testing.assert_array_equal(bits(a.numpy()), bits(b))

    def test_decoded_messages_are_views_of_one_tensor(self):
        frames = wire.encode_batch(comm_msgs(), block=64, device="cpu")
        out = wire.decode_blob(blob(frames), frames[0]["hdr"], device="cpu")
        assert len({t.untyped_storage().data_ptr() for t in out}) == 1


class TestCompressChunnelContract:
    """tests/test_comm.py::TestBatchedDatapathContract and TestFusedWire,
    on the port's chunnel."""

    @pytest.mark.parametrize("n", [0, 1, 3, 64])
    def test_batch_contract(self, n):
        tx, rx = fabric_pair(CompressChunnel(block=64, chunk_bytes=256, device="cpu"))
        rng = np.random.default_rng(n)
        msgs = [rng.standard_normal(17 + i).astype(np.float32) for i in range(n)]
        tx.send(msgs)
        got = drain(rx, n)
        assert len(got) == n
        for a, b in zip(msgs, got):
            assert tuple(b.shape) == a.shape
            amax = np.abs(a).max(initial=0.0)
            np.testing.assert_allclose(a, b.numpy(), atol=amax / 100.0 + 1e-6)

    def test_chunked_reassembly_over_fabric(self):
        tx, rx = fabric_pair(CompressChunnel(block=64, chunk_bytes=128, device="cpu"))
        msgs = [np.random.default_rng(3).standard_normal(500).astype(np.float32)]
        tx.send(msgs)
        got = drain(rx, 1)
        assert len(got) == 1 and tuple(got[0].shape) == (500,)

    def test_one_blob_one_header_per_batch(self):
        rng = np.random.default_rng(2)
        msgs = [rng.standard_normal(64).astype(np.float32) for _ in range(32)]
        frames = wire.encode_batch(msgs, block=64, device="cpu")
        assert len({f["_wire"][0] for f in frames}) == 1
        assert sum(f["hdr"] is not None for f in frames) == 1

    def test_name_and_capability_match_reference(self, ref_wire):
        for block in (64, 256):
            mine = CompressChunnel(block=block, device="cpu")
            ref = ref_wire.CompressChunnel(block=block)
            assert mine.fingerprint() == ref.fingerprint()
            assert vars(mine.cost_model()) == vars(ref.cost_model())


class TestDefaultDevice:
    def test_default_cuda_without_gpu_raises(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        frames = wire.encode_batch(comm_msgs(), block=64, device="cpu")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            wire.encode_batch(comm_msgs(), block=64)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            wire.decode_blob(blob(frames), frames[0]["hdr"])
        with pytest.raises(RuntimeError, match="no CUDA device"):
            CompressChunnel(block=64)


@pytest.mark.cuda
class TestOnCard:
    @pytest.mark.parametrize("where", ["numpy", "cuda"])
    def test_one_launch_each_way_per_batch(self, cuda, where):
        msgs = comm_msgs(seed=5)
        if where == "cuda":
            msgs = [torch.from_numpy(m).to(cuda) for m in msgs]
        n0 = (quantize_pack.launches, unpack_dequant.launches)
        frames = wire.encode_batch(msgs, block=64)
        assert blob(frames) == blob(wire.encode_batch(comm_msgs(seed=5), block=64,
                                                      device="cpu"))
        out = wire.decode_blob(blob(frames), frames[0]["hdr"])
        assert all(t.device.type == "cuda" for t in out)
        assert (quantize_pack.launches, unpack_dequant.launches) == (n0[0] + 1, n0[1] + 1)

    def test_chunnel_over_fabric_on_card(self, cuda):
        tx, rx = fabric_pair(CompressChunnel(block=256))
        msgs = [torch.randn(1000, 7, device=cuda), torch.randn(3, device=cuda)]
        tx.send(msgs)
        got = drain(rx, 2)
        assert [tuple(t.shape) for t in got] == [(1000, 7), (3,)]
        assert all(t.device.type == "cuda" for t in got)

    def test_message_on_another_device_raises(self, cuda):
        msgs = [torch.randn(100, device=cuda)]
        with pytest.raises(ValueError, match="lies on cuda"):
            wire.encode_batch(msgs, block=64, device="cpu")
