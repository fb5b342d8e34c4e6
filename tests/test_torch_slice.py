"""The port's first slice end to end on the CPU, at the widths of the
llama3.2-1b smoke config: two host agents negotiate a Select of two int8
wires (block 256, block 64), stream a decoder layer's gradients as two
batches, swap the wire under two-phase commit and stream them again.

What arrives must equal, bit for bit, what the reference's
``encode_batch`` -> ``decode_blob`` gives for the same numpy inputs at the
block that carried them.
"""
import numpy as np
import pytest
import torch

from repro_torch.comm.session import run_swap_session

# llama3.2-1b smoke widths (src/repro/configs/llama3_2_1b.py::smoke_config)
D_MODEL, N_HEADS, N_KV, HEAD_DIM, D_FF = 64, 4, 2, 16, 128
ATTN = [(N_HEADS * HEAD_DIM, D_MODEL), (N_KV * HEAD_DIM, D_MODEL),
        (N_KV * HEAD_DIM, D_MODEL), (D_MODEL, N_HEADS * HEAD_DIM), (D_MODEL,)]
MLP = [(D_FF, D_MODEL), (D_FF, D_MODEL), (D_MODEL, D_FF), (D_MODEL,)]


@pytest.fixture(scope="module")
def ref_wire():
    return pytest.importorskip("repro.comm.wire")


def layer_batches(seed):
    rng = np.random.default_rng(seed)
    return [[(rng.standard_normal(s) * 1e-3).astype(np.float32) for s in spec]
            for spec in (ATTN, MLP)]


@pytest.mark.parametrize("as_tensors", [False, True], ids=["numpy", "torch"])
def test_slice_matches_reference_bit_for_bit(ref_wire, as_tensors):
    batches = layer_batches(seed=11)
    sent = batches + batches
    msgs = [[torch.from_numpy(a) for a in b] for b in sent] if as_tensors else sent
    res = run_swap_session(msgs, blocks=(256, 64), swap_after=2, device="cpu")

    assert res.swapped and res.client_switches == 1 and res.server_switches == 1
    assert res.client_blocks == res.server_blocks == [256, 256, 64, 64]
    assert len(res.received) == len(sent)
    for batch, got, block in zip(sent, res.received, res.client_blocks):
        frames = ref_wire.encode_batch(batch, block=block)
        want = ref_wire.decode_blob(b"".join(f["data"] for f in frames), frames[0]["hdr"])
        assert len(got) == len(batch)
        for g, w in zip(got, want):
            assert g.device.type == "cpu" and g.dtype == torch.float32
            assert tuple(g.shape) == w.shape
            np.testing.assert_array_equal(g.numpy().view(np.uint32),
                                          np.ascontiguousarray(w).view(np.uint32))


def test_swap_changes_the_bytes_on_the_wire():
    """The two wires really differ: block 64 carries four times the scales."""
    batches = layer_batches(seed=3)
    res = run_swap_session(batches + batches, device="cpu")
    before, after = res.received[:2], res.received[2:]
    diff = [not torch.equal(a, b) for x, y in zip(before, after) for a, b in zip(x, y)]
    assert any(diff)
