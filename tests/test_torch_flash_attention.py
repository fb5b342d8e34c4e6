"""The port's flash attention against the reference's Pallas kernel.

On CPU tensors the wrapper runs its plain version (``flash_attention_ref``);
it is held to ``repro.kernels.flash_attention.ops.flash_attention``, which
runs the Pallas kernel in interpret mode on the CPU, over the reference's
own sweep (``tests/test_kernels.py::TestFlashAttentionKernel``) plus head dim
128 and query and key lengths that differ. Inputs come from numpy with a
seed and are handed to both as the same values.

Tolerances: float32 outputs within 2e-5 (both sum in float32, the kernel
tile by tile with an online softmax, the plain version at once); bfloat16
outputs within 1e-2, about one bfloat16 step at the outputs' magnitude (both
compute in float32 and round once at the end, so they differ where the
float32 results straddle a rounding boundary). The reference's own tests
allow 2e-2 and 3e-3.

Tests marked ``cuda`` hold the Hopper kernel to the plain version on the
card and skip without one.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention.flash_attention import (
    HEAD_DIMS,
    flash_attention,
    flash_attention_ref,
)

TOL = {"float32": 2e-5, "bfloat16": 1e-2}


@pytest.fixture(scope="module")
def ref_ops():
    return pytest.importorskip("repro.kernels.flash_attention.ops")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def make_qkv(B, Sq, H, KH, hd, dtype, seed, Skv=None):
    """Seeded float32 numpy inputs, rounded to ``dtype`` and back."""
    rng = np.random.default_rng(seed)
    shapes = [(B, Sq, H, hd), (B, Skv or Sq, KH, hd), (B, Skv or Sq, KH, hd)]
    out = []
    for s in shapes:
        t = torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(getattr(torch, dtype))
        out.append(t)
    return out


def run_reference(ref_ops, q, k, v, **kw):
    import jax.numpy as jnp

    def to_jax(t):
        dt = jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32
        return jnp.asarray(t.float().numpy()).astype(dt)

    out = ref_ops.flash_attention(to_jax(q), to_jax(k), to_jax(v), **kw)
    return np.asarray(out, np.float32)


def assert_matches(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(), want, atol=TOL[dtype], rtol=TOL[dtype])


class TestAgainstReference:
    @pytest.mark.parametrize("B,S,H,KH,hd", [
        (1, 128, 4, 4, 64),   # MHA
        (2, 256, 8, 2, 32),   # GQA 4:1
        (1, 384, 6, 1, 64),   # MQA
        (2, 96, 4, 2, 16),    # ragged block boundary (S % block != 0)
        (1, 192, 4, 2, 128),  # mistral-nemo's head width
    ])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_matches_pallas_sweep(self, ref_ops, B, S, H, KH, hd, dtype):
        q, k, v = make_qkv(B, S, H, KH, hd, dtype, seed=S + hd)
        got = flash_attention(q, k, v, causal=True)
        assert got.dtype == q.dtype and got.shape == q.shape
        assert_matches(got, run_reference(ref_ops, q, k, v, causal=True, block_q=64,
                                          block_k=64), dtype)

    @pytest.mark.parametrize("window", [16, 64])
    def test_sliding_window(self, ref_ops, window):
        q, k, v = make_qkv(1, 128, 2, 2, 32, "float32", seed=window)
        got = flash_attention(q, k, v, causal=True, window=window)
        assert_matches(got, run_reference(ref_ops, q, k, v, causal=True, window=window,
                                          block_q=32, block_k=32), "float32")

    def test_non_causal(self, ref_ops):
        q, k, v = make_qkv(2, 64, 2, 2, 16, "float32", seed=2)
        got = flash_attention(q, k, v, causal=False)
        assert_matches(got, run_reference(ref_ops, q, k, v, causal=False, block_q=32,
                                          block_k=32), "float32")

    @pytest.mark.parametrize("Sq,Skv", [(64, 160), (96, 40)])
    def test_query_and_key_lengths_differ(self, ref_ops, Sq, Skv):
        """The causal mask is top-left aligned: query row i sees keys 0..i,
        whatever Skv (FlashAttention-2 would align the last rows instead)."""
        q, k, v = make_qkv(2, Sq, 4, 2, 32, "float32", seed=Sq, Skv=Skv)
        got = flash_attention(q, k, v, causal=True)
        assert_matches(got, run_reference(ref_ops, q, k, v, causal=True, block_q=32,
                                          block_k=32), "float32")


class TestPlainVersion:
    def test_top_left_alignment(self):
        """Query row 0 sees key 0 alone, so its output is v[0] of its KV head."""
        q, k, v = make_qkv(2, 3, 4, 2, 16, "float32", seed=0, Skv=10)
        out = flash_attention_ref(q, k, v, causal=True)
        torch.testing.assert_close(out[:, 0], v[:, 0].repeat_interleave(2, dim=1),
                                   atol=1e-6, rtol=1e-6)

    def test_row_with_nothing_kept_is_zero(self):
        """window 0 keeps no key: the clamped l gives 0, not NaN."""
        q, k, v = make_qkv(1, 8, 2, 2, 16, "float32", seed=1)
        out = flash_attention_ref(q, k, v, causal=True, window=0)
        assert torch.equal(out, torch.zeros_like(out))


class TestWrapperContract:
    def test_cpu_runs_plain_and_counts_no_launch(self):
        before = flash_attention.launches
        q, k, v = make_qkv(1, 16, 4, 2, 16, "bfloat16", seed=3)
        assert torch.equal(flash_attention(q, k, v), flash_attention_ref(q, k, v))
        assert flash_attention.launches == before

    @pytest.mark.parametrize("bad", ["float16", "mixed", "shape", "heads", "meta", "3d"])
    def test_rejects(self, bad):
        q, k, v = make_qkv(1, 16, 4, 2, 16, "float32", seed=4)
        if bad == "float16":
            q, k, v = q.half(), k.half(), v.half()
        elif bad == "mixed":
            k = k.bfloat16()
        elif bad == "shape":
            v = v[:, :8]
        elif bad == "heads":
            q = torch.cat([q, q[:, :, :1]], dim=2)  # 5 heads over 2 KV heads
        elif bad == "meta":
            q, k, v = q.to("meta"), k.to("meta"), v.to("meta")
        else:
            q = q[0]
        with pytest.raises(ValueError):
            flash_attention(q, k, v)


@pytest.mark.cuda
class TestKernelAgainstPlain:
    @pytest.mark.parametrize("case", [
        dict(shape=(2, 256, 8, 2, 64), dtype="bfloat16", causal=True),
        dict(shape=(2, 200, 8, 2, 64), dtype="bfloat16", causal=True),
        dict(shape=(1, 512, 8, 8, 64), dtype="bfloat16", causal=True, window=128),
        dict(shape=(2, 96, 4, 2, 16), dtype="float32", causal=True),
        dict(shape=(2, 256, 8, 2, 32), dtype="float32", causal=False),
        dict(shape=(1, 192, 4, 1, 128), dtype="bfloat16", causal=True),
        dict(shape=(2, 64, 4, 2, 32), dtype="float32", causal=True, skv=160),
        dict(shape=(2, 96, 4, 2, 32), dtype="float32", causal=True, skv=40),
    ], ids=["gqa", "ragged", "window", "hd16", "noncausal", "hd128", "skv-longer",
            "skv-shorter"])
    def test_kernel_matches_plain_on_card(self, cuda, case):
        B, S, H, KH, hd = case["shape"]
        q, k, v = (t.to(cuda) for t in make_qkv(B, S, H, KH, hd, case["dtype"], seed=S,
                                                Skv=case.get("skv")))
        kw = dict(causal=case["causal"], window=case.get("window"))
        n0 = flash_attention.launches
        got = flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        assert flash_attention.launches == n0 + 1
        assert got.device.type == "cuda" and got.dtype == q.dtype
        want = flash_attention_ref(q, k, v, **kw)
        tol = TOL[case["dtype"]]
        torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)

    def test_strided_inputs(self, cuda):
        """q, k, v read through their strides: slices of a fused qkv."""
        qkv = torch.randn(2, 128, 12, 32, device=cuda)
        q, k, v = qkv[:, :, :8], qkv[:, :, 8:10], qkv[:, :, 10:]
        torch.testing.assert_close(flash_attention(q, k, v), flash_attention_ref(q, k, v),
                                   atol=TOL["float32"], rtol=TOL["float32"])

    def test_head_dim_not_built_raises(self, cuda):
        q = torch.randn(1, 16, 2, 48, device=cuda)
        assert 48 not in HEAD_DIMS
        with pytest.raises(ValueError):
            flash_attention(q, q, q)
