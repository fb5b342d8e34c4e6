"""The port's SSM chunk scan against the reference's Pallas kernel.

On CPU tensors the wrapper runs its plain version (``ssm_scan_chunk_ref``, a
float32 loop over t); it is held to ``repro.kernels.ssm_scan.ops
.ssm_scan_chunk``, which runs the Pallas kernel in interpret mode on the CPU,
and to the reference's oracle ``ssm_scan_chunk_ref`` (the associative scan of
``models/ssm.py::_scan_chunk``), over the reference's own sweep
(``tests/test_kernels.py::TestSsmScanKernel``), its composition property and
a = 1. Inputs come from numpy with a seed and are handed to both as the same
values.

Tolerance: atol = rtol = 1e-5, the reference's own. The Pallas kernel and
the plain version run the same float32 recurrence step by step; the
associative scan takes its products in another order.

Tests marked ``cuda`` hold the Hopper kernel to the plain version on the card
and skip without one. The kernel rounds the product and the sum one at a
time, as the plain version does, so there they agree bit for bit.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.ssm_scan.ssm_scan import ssm_scan_chunk, ssm_scan_chunk_ref

TOL = dict(atol=1e-5, rtol=1e-5)
SWEEP = [(1, 16, 32, 4), (2, 64, 256, 16), (3, 8, 300, 16)]  # incl. d % 256 != 0


@pytest.fixture(scope="module")
def ref():
    ops = pytest.importorskip("repro.kernels.ssm_scan.ops")
    from repro.kernels.ssm_scan.ref import ssm_scan_chunk_ref as oracle

    return ops.ssm_scan_chunk, oracle


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def make_inputs(B, C, d, N, seed, h0_scale=0.1):
    """The reference's test inputs: a = sigmoid(normal), a decay in (0, 1);
    bx and h0 normal times 0.1."""
    rng = np.random.default_rng(seed)
    a = 1.0 / (1.0 + np.exp(-rng.standard_normal((B, C, d, N))))
    bx = rng.standard_normal((B, C, d, N)) * 0.1
    h0 = rng.standard_normal((B, d, N)) * h0_scale
    return [torch.from_numpy(x.astype(np.float32)) for x in (a, bx, h0)]


def run_reference(fn, a, bx, h0):
    import jax.numpy as jnp

    h_seq, h_last = fn(*(jnp.asarray(t.numpy()) for t in (a, bx, h0)))
    return np.asarray(h_seq), np.asarray(h_last)


class TestAgainstReference:
    @pytest.mark.parametrize("B,C,d,N", SWEEP)
    @pytest.mark.parametrize("which", ["pallas", "oracle"])
    def test_matches_reference_sweep(self, ref, which, B, C, d, N):
        a, bx, h0 = make_inputs(B, C, d, N, seed=C + d)
        h_seq, h_last = ssm_scan_chunk(a, bx, h0)
        assert h_seq.shape == (B, C, d, N) and h_last.shape == (B, d, N)
        assert h_seq.dtype == h_last.dtype == torch.float32
        want_seq, want_last = run_reference(ref[0] if which == "pallas" else ref[1], a, bx, h0)
        np.testing.assert_allclose(h_seq.numpy(), want_seq, **TOL)
        np.testing.assert_allclose(h_last.numpy(), want_last, **TOL)

    @pytest.mark.parametrize("seed,C", [(0, 4), (1, 10), (2, 33), (3, 64)])
    def test_composition(self, ref, seed, C):
        """Scanning a chunk equals scanning its two halves in turn, the
        second from the first's h_last (the reference's property test)."""
        a, bx, _ = make_inputs(1, C, 16, 4, seed)
        h0 = torch.zeros(1, 16, 4)
        _, h_full = ssm_scan_chunk(a, bx, h0)
        _, h_half = ssm_scan_chunk(a[:, :C // 2], bx[:, :C // 2], h0)
        seq_two, h_two = ssm_scan_chunk(a[:, C // 2:], bx[:, C // 2:], h_half)
        np.testing.assert_allclose(h_two.numpy(), h_full.numpy(), **TOL)
        want_seq, want_last = run_reference(ref[0], a, bx, h0)
        np.testing.assert_allclose(h_two.numpy(), want_last, **TOL)
        np.testing.assert_allclose(seq_two.numpy(), want_seq[:, C // 2:], **TOL)

    def test_identity_decay_accumulates(self, ref):
        """a = 1 gives h_last = h0 + sum_t bx_t."""
        _, bx, h0 = make_inputs(1, 8, 8, 4, seed=3, h0_scale=1.0)
        bx = bx * 10
        a = torch.ones_like(bx)
        h_seq, h_last = ssm_scan_chunk(a, bx, h0)
        np.testing.assert_allclose(h_last.numpy(), (h0 + bx.sum(dim=1)).numpy(), atol=1e-5)
        np.testing.assert_allclose(h_seq.numpy(), (h0[:, None] + bx.cumsum(dim=1)).numpy(),
                                   atol=1e-5)
        np.testing.assert_allclose(h_last.numpy(), run_reference(ref[0], a, bx, h0)[1], **TOL)


class TestWrapperContract:
    def test_cpu_runs_plain_and_counts_no_launch(self):
        before = ssm_scan_chunk.launches
        a, bx, h0 = make_inputs(2, 5, 6, 4, seed=1)
        got, want = ssm_scan_chunk(a, bx, h0), ssm_scan_chunk_ref(a, bx, h0)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
        assert ssm_scan_chunk.launches == before

    def test_chunk_of_a_longer_sequence(self):
        """A chunk sliced out of (B, S, d, N) (a view with a longer batch
        stride) scans as its copy does."""
        a, bx, h0 = make_inputs(2, 12, 6, 4, seed=2)
        view = ssm_scan_chunk(a[:, 4:8], bx[:, 4:8], h0)
        copy = ssm_scan_chunk(a[:, 4:8].clone(), bx[:, 4:8].clone(), h0)
        assert all(torch.equal(v, c) for v, c in zip(view, copy))

    def test_plain_rounds_product_and_sum_apart(self):
        """One step is fl(fl(a * h) + bx), not a fused multiply-add: the
        rounding the kernel reproduces with __fmul_rn and __fadd_rn."""
        a, bx, h0 = make_inputs(1, 1, 64, 16, seed=5)
        _, h = ssm_scan_chunk_ref(a, bx, h0)
        assert torch.equal(h, (a[:, 0] * h0) + bx[:, 0])

    @pytest.mark.parametrize("bad", ["float64", "bfloat16", "bx shape", "h0 shape", "meta",
                                     "3d", "empty"])
    def test_rejects(self, bad):
        a, bx, h0 = make_inputs(1, 4, 8, 4, seed=4)
        if bad == "float64":
            a, bx, h0 = a.double(), bx.double(), h0.double()
        elif bad == "bfloat16":
            bx = bx.bfloat16()
        elif bad == "bx shape":
            bx = bx[:, :2]
        elif bad == "h0 shape":
            h0 = h0[:, :4]
        elif bad == "meta":
            a, bx, h0 = a.to("meta"), bx.to("meta"), h0.to("meta")
        elif bad == "3d":
            a, bx = a[0], bx[0]
        else:
            a, bx = a[:, :0], bx[:, :0]
        with pytest.raises(ValueError):
            ssm_scan_chunk(a, bx, h0)


@pytest.mark.cuda
class TestKernelAgainstPlain:
    @pytest.mark.parametrize("B,C,d,N", SWEEP + [(4, 1, 3200, 16), (2, 256, 3200, 16)],
                             ids=["small", "mid", "d300", "decode", "prefill-chunk"])
    def test_kernel_matches_plain_on_card(self, cuda, B, C, d, N):
        a, bx, h0 = (t.to(cuda) for t in make_inputs(B, C, d, N, seed=C + d))
        n0 = ssm_scan_chunk.launches
        h_seq, h_last = ssm_scan_chunk(a, bx, h0)
        torch.cuda.synchronize()
        assert ssm_scan_chunk.launches == n0 + 1
        want_seq, want_last = ssm_scan_chunk_ref(a, bx, h0)
        assert h_seq.device.type == "cuda" and h_seq.dtype == torch.float32
        torch.testing.assert_close(h_seq, want_seq, **TOL)
        torch.testing.assert_close(h_last, want_last, **TOL)

    def test_strided_chunk_and_composition(self, cuda):
        a, bx, h0 = (t.to(cuda) for t in make_inputs(2, 64, 300, 16, seed=7))
        _, h_full = ssm_scan_chunk(a, bx, h0)
        _, h_half = ssm_scan_chunk(a[:, :32], bx[:, :32], h0)
        seq_two, h_two = ssm_scan_chunk(a[:, 32:], bx[:, 32:], h_half)
        torch.testing.assert_close(h_two, h_full, **TOL)
        torch.testing.assert_close(seq_two, ssm_scan_chunk_ref(a, bx, h0)[0][:, 32:], **TOL)

    def test_identity_decay_accumulates(self, cuda):
        _, bx, h0 = (t.to(cuda) for t in make_inputs(2, 40, 64, 16, seed=8, h0_scale=1.0))
        _, h_last = ssm_scan_chunk(torch.ones_like(bx), bx, h0)
        torch.testing.assert_close(h_last, (h0.double() + bx.double().sum(dim=1)).float(),
                                   **TOL)

    def test_inner_stride_raises(self, cuda):
        a, bx, h0 = (t.to(cuda) for t in make_inputs(1, 4, 8, 4, seed=9))
        with pytest.raises(ValueError):
            ssm_scan_chunk(a.transpose(2, 3).contiguous().transpose(2, 3), bx, h0)
