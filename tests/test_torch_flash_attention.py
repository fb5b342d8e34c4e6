"""The port's flash attention against the reference's Pallas kernel.

On CPU tensors the wrapper runs its plain version (``flash_attention_ref``);
it is held to ``repro.kernels.flash_attention.ops.flash_attention``, which
runs the Pallas kernel in interpret mode on the CPU, over the reference's
own sweep (``tests/test_kernels.py::TestFlashAttentionKernel``) plus head dims
96 (phi-3-vision's) and 128 and query and key lengths that differ. Inputs come from numpy with a
seed and are handed to both as the same values.

Tolerances: float32 outputs within 2e-5 (both sum in float32, the kernel
tile by tile with an online softmax, the plain version at once); bfloat16
outputs within 1e-2, about one bfloat16 step at the outputs' magnitude (both
compute in float32 and round once at the end, so they differ where the
float32 results straddle a rounding boundary). The reference's own tests
allow 2e-2 and 3e-3.

On the card, bfloat16 inputs take the tensor-core route, which rounds the
softmax weights p to bfloat16 for the P.V product (the A operand of the
tensor cores) while it sums l from the unrounded float32 p. ``emulate_tc``
states that arithmetic in plain PyTorch, and ``TestTensorCoreContract``
holds it to the reference's Pallas kernel within atol = rtol = 1e-2, the
tolerance the card's kernel is held to against the plain version.

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
    tma_strides,
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
        (1, 160, 4, 4, 96),   # phi-3-vision's head width: two 64-column boxes, half padding
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


def emulate_tc(q, k, v, *, causal=True, window=None):
    """The tensor-core route's arithmetic: bfloat16 inputs, float32 scores,
    an online softmax over key tiles of 128 (64 at head dims 96 and 128), p rounded
    to bfloat16 for each tile's P.V, l the sum of the float32 p, and the
    output cast to q's dtype."""
    B, Sq, H, hd = q.shape
    Skv, group = k.shape[1], H // k.shape[2]
    bk = 64 if hd > 64 else 128
    qf = q.float()
    kf = k.float().repeat_interleave(group, dim=2)
    vf = v.float().repeat_interleave(group, dim=2)
    qpos = torch.arange(Sq)[:, None]
    m = torch.full((B, H, Sq), -1e30)
    l = torch.zeros(B, H, Sq)
    acc = torch.zeros(B, H, Sq, hd)
    for k0 in range(0, Skv, bk):
        kpos = torch.arange(k0, min(Skv, k0 + bk))[None, :]
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kf[:, k0:k0 + bk]) * hd**-0.5
        ok = torch.ones(Sq, kpos.shape[1], dtype=torch.bool)
        if causal:
            ok &= kpos <= qpos
        if window is not None:
            ok &= qpos - kpos < window
        s = s.masked_fill(~ok, float("-inf"))
        m_new = torch.maximum(m, s.amax(dim=-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * corr + p.sum(dim=-1)
        pv = torch.einsum("bhqk,bkhd->bhqd", p.bfloat16().float(), vf[:, k0:k0 + bk])
        acc = acc * corr[..., None] + pv
        m = m_new
    o = acc / l.clamp_min(1e-20)[..., None]
    return o.transpose(1, 2).to(q.dtype)


class TestTensorCoreContract:
    """The bf16 route's rounding of p, emulated, against the Pallas kernel."""

    @pytest.mark.parametrize("B,Sq,H,KH,hd,skv,kw", [
        (1, 128, 4, 4, 64, None, dict(causal=True)),
        (2, 256, 8, 2, 32, None, dict(causal=True)),
        (1, 384, 6, 1, 64, None, dict(causal=True)),
        (2, 96, 4, 2, 16, None, dict(causal=True)),
        (1, 192, 4, 2, 128, None, dict(causal=True)),
        (1, 300, 5, 1, 64, None, dict(causal=True, window=128)),
        (2, 64, 2, 2, 16, None, dict(causal=False)),
        (2, 64, 4, 2, 32, 160, dict(causal=True)),
        (2, 96, 4, 2, 32, 40, dict(causal=True)),
        (1, 200, 4, 4, 96, None, dict(causal=True)),
    ], ids=["mha", "gqa", "mqa", "ragged-hd16", "hd128", "window", "noncausal", "skv-longer",
            "skv-shorter", "hd96"])
    def test_emulated_rounding_matches_pallas(self, ref_ops, B, Sq, H, KH, hd, skv, kw):
        q, k, v = make_qkv(B, Sq, H, KH, hd, "bfloat16", seed=Sq + hd + 7, Skv=skv)
        got = emulate_tc(q, k, v, **kw)
        assert got.dtype == torch.bfloat16 and got.shape == q.shape
        want = run_reference(ref_ops, q, k, v, block_q=64, block_k=64, **kw)
        np.testing.assert_allclose(got.float().numpy(), want, atol=1e-2, rtol=1e-2)

    def test_emulation_differs_from_plain_only_by_rounding_p(self):
        """Across tiles of 128 keys the emulation and the plain f32 version
        agree within the bf16 route's tolerance, and not bit for bit: the
        rounding of p is a real change, stated rather than hidden."""
        q, k, v = make_qkv(1, 512, 4, 1, 64, "bfloat16", seed=11)
        got, want = emulate_tc(q, k, v), flash_attention_ref(q, k, v)
        torch.testing.assert_close(got.float(), want.float(), atol=1e-2, rtol=1e-2)
        assert not torch.equal(got, want)

    def test_row_with_nothing_kept_is_zero(self):
        q, k, v = make_qkv(1, 96, 2, 1, 64, "bfloat16", seed=5, Skv=40)
        out = emulate_tc(q, k, v, causal=True, window=16)
        assert torch.equal(out[:, 55:], torch.zeros_like(out[:, 55:]))
        assert out[:, :55].abs().amax() > 0


class TestTmaStrides:
    """The bf16 route's layout check, which runs before any launch."""

    def test_contiguous_and_fused_slices_pass(self):
        q = torch.zeros(2, 16, 4, 32, dtype=torch.bfloat16)
        assert tma_strides(q) == q.stride()[:3]
        qkv = torch.zeros(2, 16, 12, 32, dtype=torch.bfloat16)
        for part in (qkv[:, :, :8], qkv[:, :, 8:10], qkv[:, :, 10:]):
            assert tma_strides(part) == part.stride()[:3]

    def test_length_one_dims_take_a_valid_stride(self):
        x = torch.zeros(1, 16, 20, 16, dtype=torch.bfloat16)[:, :, :1]
        assert x.stride() == (5120, 320, 16, 1)
        assert tma_strides(x) == (16, 320, 16)

    @pytest.mark.parametrize("bad", ["head-stride", "seq-stride", "base", "broadcast"])
    def test_rejects_what_tma_cannot_read(self, bad):
        if bad == "head-stride":  # 20 bf16 = 40 bytes between heads
            x = torch.zeros(1, 8, 4, 20, dtype=torch.bfloat16)[..., :16]
        elif bad == "seq-stride":  # 3 heads of 16 = 96 bytes, then 2 more elements
            x = torch.zeros(1, 8, 3 * 16 + 2, dtype=torch.bfloat16)[..., :48].unflatten(2, (3, 16))
        elif bad == "base":
            x = torch.zeros(1 + 8 * 2 * 16, dtype=torch.bfloat16)[1:].view(1, 8, 2, 16)
        else:
            x = torch.zeros(1, 1, 2, 16, dtype=torch.bfloat16).expand(1, 8, 2, 16)
        with pytest.raises(ValueError):
            tma_strides(x)


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
        before = flash_attention.launches, dict(flash_attention.shape_launches)
        q, k, v = make_qkv(1, 16, 4, 2, 16, "bfloat16", seed=3)
        assert torch.equal(flash_attention(q, k, v), flash_attention_ref(q, k, v))
        assert (flash_attention.launches, dict(flash_attention.shape_launches)) == before

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
        dict(shape=(2, 200, 4, 4, 96), dtype="float32", causal=True),
        dict(shape=(2, 200, 4, 4, 96), dtype="bfloat16", causal=True),
    ], ids=["gqa", "ragged", "window", "hd16", "noncausal", "hd128", "skv-longer",
            "skv-shorter", "hd96-float32", "hd96-bfloat16"])
    def test_kernel_matches_plain_on_card(self, cuda, case):
        B, S, H, KH, hd = case["shape"]
        q, k, v = (t.to(cuda) for t in make_qkv(B, S, H, KH, hd, case["dtype"], seed=S,
                                                Skv=case.get("skv")))
        kw = dict(causal=case["causal"], window=case.get("window"))
        n0 = flash_attention.launches
        key = (tuple(q.shape), tuple(k.shape), case["causal"])
        s0 = flash_attention.shape_launches[key]
        got = flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        assert flash_attention.launches == n0 + 1
        assert flash_attention.shape_launches[key] == s0 + 1
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


@pytest.mark.cuda
class TestTensorCoreRoute:
    """bfloat16 inputs on the card: the wgmma + TMA kernel, held to the plain
    version within atol = rtol = 1e-2 (p is rounded to bf16 for P.V)."""

    @pytest.mark.parametrize("case", [
        dict(shape=(2, 200, 8, 2, 64), causal=True),
        dict(shape=(1, 2000, 8, 2, 64), causal=True),
        dict(shape=(2, 64, 4, 2, 64), skv=300, causal=True),
        dict(shape=(2, 300, 4, 2, 64), skv=100, causal=True),
        dict(shape=(2, 300, 4, 2, 64), skv=700, causal=False),
        dict(shape=(1, 512, 4, 1, 64), causal=True, window=128),
        dict(shape=(1, 2048, 5, 1, 64), causal=True, window=1024),
        dict(shape=(1, 384, 25, 5, 64), causal=True),
        dict(shape=(2, 256, 4, 2, 16), causal=True),
        dict(shape=(2, 256, 4, 2, 32), causal=True),
        dict(shape=(2, 256, 4, 2, 64), causal=False),
        dict(shape=(2, 320, 4, 2, 128), causal=True, window=100),
        dict(shape=(2, 300, 8, 8, 96), causal=True),
        dict(shape=(2, 300, 4, 4, 96), skv=100, causal=False),
    ], ids=["sq200", "sq2000", "skv-longer", "skv-shorter", "noncausal-skv-longer",
            "window128", "window1024", "gqa25-5", "hd16", "hd32", "hd64-noncausal",
            "hd128-window", "hd96", "hd96-noncausal-skv-shorter"])
    def test_matches_plain(self, cuda, case):
        B, S, H, KH, hd = case["shape"]
        q, k, v = (t.to(cuda) for t in make_qkv(B, S, H, KH, hd, "bfloat16", seed=S + hd,
                                                Skv=case.get("skv")))
        kw = dict(causal=case["causal"], window=case.get("window"))
        n0 = flash_attention.launches
        got = flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        assert flash_attention.launches == n0 + 1
        assert got.dtype == torch.bfloat16 and got.shape == q.shape
        want = flash_attention_ref(q, k, v, **kw)
        torch.testing.assert_close(got.float(), want.float(), atol=1e-2, rtol=1e-2)
        torch.testing.assert_close(got.float(), emulate_tc(q.cpu(), k.cpu(), v.cpu(), **kw)
                                   .float().to(cuda), atol=1e-2, rtol=1e-2)

    def test_row_with_nothing_kept_is_zero(self, cuda):
        """Rows from 55 on keep no key (qpos - kpos < 16 needs kpos > 39)."""
        q, k, v = (t.to(cuda) for t in make_qkv(1, 96, 2, 1, 64, "bfloat16", seed=5, Skv=40))
        got = flash_attention(q, k, v, causal=True, window=16)
        assert torch.equal(got[:, 55:], torch.zeros_like(got[:, 55:]))
        torch.testing.assert_close(got.float(), flash_attention_ref(q, k, v, causal=True,
                                                                    window=16).float(),
                                   atol=1e-2, rtol=1e-2)

    def test_fused_qkv_slices(self, cuda):
        qkv = torch.randn(2, 256, 12, 64, device=cuda).bfloat16()
        q, k, v = qkv[:, :, :8], qkv[:, :, 8:10], qkv[:, :, 10:]
        torch.testing.assert_close(flash_attention(q, k, v).float(),
                                   flash_attention_ref(q, k, v).float(), atol=1e-2, rtol=1e-2)

    def test_misaligned_stride_raises(self, cuda):
        x = torch.randn(1, 64, 4, 20, device=cuda).bfloat16()[..., :16]
        n0 = flash_attention.launches
        with pytest.raises(ValueError):
            flash_attention(x, x[:, :, :2], x[:, :, :2])
        assert flash_attention.launches == n0
