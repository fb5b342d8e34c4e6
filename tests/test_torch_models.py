"""The port's dense-family layers and attention against the reference's.

Inputs come from numpy with a seed; both packages get the same values.
Tolerances, by what is compared:
- float32 arithmetic (norm before its cast, RoPE, attention on float32
  inputs): 1e-5, the two libraries' rounding of exp, rsqrt, sin and cos;
- a bfloat16 result of float32 arithmetic (norms, RoPE on bfloat16): one
  bfloat16 step, rtol 2**-7 (the float32 values may straddle a rounding
  boundary);
- bfloat16 matrix products (MLP, attention on bfloat16 inputs): 2e-2, a
  couple of bfloat16 steps at these magnitudes, since XLA and ATen round the
  products' outputs at different points.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs as tconfigs
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tl
from repro_torch.models.convert import flatten, params_from_reference
from repro_torch.models.registry import build, model_class

DENSE = ["llama3.2-1b", "qwen2-7b", "mistral-nemo-12b", "granite-34b"]
BF16_STEP = 2.0**-7


@pytest.fixture(scope="module")
def jnp():
    return pytest.importorskip("jax.numpy")


@pytest.fixture(scope="module")
def ref_layers():
    return pytest.importorskip("repro.models.layers")


@pytest.fixture(scope="module")
def ref_attn():
    return pytest.importorskip("repro.models.attention")


def rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def to_np(x):
    return np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) else x.detach().float().numpy()


class TestLayers:
    @pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
    def test_norm(self, jnp, ref_layers, kind):
        x = rand((3, 5, 64), 0, 3.0)
        scale, bias = rand((64,), 1) + 1.0, rand((64,), 2)
        p = {"scale": scale} | ({"bias": bias} if kind == "layernorm" else {})
        want = ref_layers.apply_norm({k: jnp.asarray(v) for k, v in p.items()},
                                     jnp.asarray(x), eps=1e-5)
        norm = tl.Norm(64, kind, eps=1e-5)
        with torch.no_grad():
            norm.scale.copy_(torch.from_numpy(scale))
            if kind == "layernorm":
                norm.bias.copy_(torch.from_numpy(bias))
        got = norm(torch.from_numpy(x))
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(to_np(got), to_np(want), rtol=BF16_STEP, atol=0)

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("hd,theta", [(16, 5e5), (64, 1e4), (128, 1e6)])
    def test_apply_rope(self, jnp, ref_layers, dtype, hd, theta):
        x = rand((2, 40, 3, hd), hd)
        pos = np.arange(7, 47)
        want = ref_layers.apply_rope(jnp.asarray(x).astype(dtype), jnp.asarray(pos), theta)
        got = tl.apply_rope(torch.from_numpy(x).to(getattr(torch, dtype)),
                            torch.from_numpy(pos), theta)
        assert got.dtype == getattr(torch, dtype)
        if dtype == "float32":
            np.testing.assert_allclose(to_np(got), to_np(want), atol=1e-5, rtol=1e-5)
        else:
            np.testing.assert_allclose(to_np(got), to_np(want), rtol=BF16_STEP, atol=1e-6)

    def test_rope_is_split_halves(self):
        """Position 1 rotates dim i with dim i + hd/2, not with its neighbour."""
        x = torch.zeros(1, 1, 1, 8)
        x[..., 0] = 1.0
        out = tl.apply_rope(x, torch.tensor([1]), 1e4)
        assert out[..., 4].item() == pytest.approx(np.sin(1.0), abs=1e-6)
        assert out[..., 1].item() == 0.0

    @pytest.mark.parametrize("gated,act", [(True, "silu"), (False, "gelu"), (True, "gelu")])
    def test_mlp(self, jnp, ref_layers, gated, act):
        d, f = 64, 128
        p = {"up": {"w": rand((d, f), 1, d**-0.5)}, "down": {"w": rand((f, d), 2, f**-0.5)}}
        if gated:
            p["gate"] = {"w": rand((d, f), 3, d**-0.5)}
        x = rand((2, 9, d), 4)
        want = ref_layers.mlp({k: {"w": jnp.asarray(v["w"])} for k, v in p.items()},
                              jnp.asarray(x), act=act)
        mlp = tl.MLP(d, f, gated=gated, act=act)
        with torch.no_grad():
            for name, leaf in p.items():
                getattr(mlp, name).w.copy_(torch.from_numpy(leaf["w"]))
        for m in mlp.modules():
            if isinstance(m, tl.Linear):
                m.prepare()
        got = mlp(torch.from_numpy(x))
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(to_np(got), to_np(want), atol=2e-2, rtol=2e-2)

    def test_gelu_is_the_tanh_form(self):
        """jax.nn.gelu defaults to the tanh approximation; torch's default is
        erf. The port's activation must be jax's."""
        jax = pytest.importorskip("jax")
        x = np.linspace(-4, 4, 101, dtype=np.float32)
        want = np.asarray(jax.nn.gelu(x))
        got = tl.activation(torch.from_numpy(x), "gelu").numpy()
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
        erf = torch.nn.functional.gelu(torch.from_numpy(x)).numpy()
        assert np.abs(erf - want).max() > 1e-4

    def test_embed_and_padded_vocab(self, jnp, ref_layers):
        table = rand((300, 16), 5, 0.02)
        tokens = np.random.default_rng(6).integers(0, 300, (2, 7))
        want = ref_layers.embed({"table": jnp.asarray(table)}, jnp.asarray(tokens))
        emb = tl.Embedding(300, 16)
        with torch.no_grad():
            emb.table.copy_(torch.from_numpy(table))
        emb.prepare()
        got = emb(torch.from_numpy(tokens))
        np.testing.assert_array_equal(to_np(got), to_np(want))
        logits = rand((2, 300), 7)
        np.testing.assert_array_equal(
            to_np(tl.mask_padded_vocab(torch.from_numpy(logits).bfloat16(), 256)),
            to_np(ref_layers.mask_padded_vocab(jnp.asarray(logits).astype("bfloat16"), 256)))


class TestAttention:
    @staticmethod
    def qkv(jnp, dtype, B=2, Sq=48, Skv=48, H=4, KH=2, hd=16, seed=0):
        arrs = [rand((B, Sq, H, hd), seed), rand((B, Skv, KH, hd), seed + 1),
                rand((B, Skv, KH, hd), seed + 2)]
        tt = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]
        jj = [jnp.asarray(t.float().numpy()).astype(dtype) for t in tt]
        return tt, jj

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("kw", [
        dict(causal=True), dict(causal=False), dict(causal=True, window=8),
        dict(causal=True, q_offset=5, kv_len=40)], ids=["causal", "full", "window", "offset"])
    def test_dense(self, jnp, ref_attn, dtype, kw):
        (q, k, v), (jq, jk, jv) = self.qkv(jnp, dtype)
        got = tattn.attention_dense(q, k, v, **kw)
        want = ref_attn.attention_dense(jq, jk, jv, **kw)
        tol = 1e-5 if dtype == "float32" else 2e-2
        assert got.dtype == q.dtype
        np.testing.assert_allclose(to_np(got), to_np(want), atol=tol, rtol=tol)

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("kw", [
        dict(causal=True, chunk=16), dict(causal=True, chunk=20), dict(causal=False, chunk=64),
        dict(causal=True, window=10, chunk=16), dict(causal=True, chunk=16, kv_len=30)],
        ids=["even", "ragged", "one-chunk", "window", "kv_len"])
    def test_chunked(self, jnp, ref_attn, dtype, kw):
        """Scores in bfloat16 whatever the inputs, so bfloat16 tolerance."""
        (q, k, v), (jq, jk, jv) = self.qkv(jnp, dtype, seed=3)
        got = tattn.attention_chunked(q, k, v, **kw)
        want = ref_attn.attention_chunked(jq, jk, jv, **kw)
        assert got.dtype == q.dtype
        np.testing.assert_allclose(to_np(got), to_np(want), atol=2e-2, rtol=2e-2)

    @pytest.mark.parametrize("cache_len,window", [(30, None), ([12, 40], None), (40, 8)])
    def test_decode_local(self, jnp, ref_attn, cache_len, window):
        (q, k, v), (jq, jk, jv) = self.qkv(jnp, "bfloat16", Sq=1, Skv=48, seed=6)
        got = tattn.decode_attention_local(q, k, v, torch.tensor(cache_len), window=window)
        want = ref_attn.decode_attention_local(jq, jk, jv, jnp.asarray(cache_len),
                                               window=window)
        np.testing.assert_allclose(to_np(got), to_np(want), atol=2e-2, rtol=2e-2)

    def test_pallas_slot_ignores_chunk_offset_and_kv_len(self, jnp):
        (q, k, v), _ = self.qkv(jnp, "float32", seed=9)
        a = tattn.attention(q, k, v, impl="pallas", chunk=8, q_offset=3, kv_len=10)
        assert torch.equal(a, tattn.attention(q, k, v, impl="pallas"))
        with pytest.raises(ValueError):
            tattn.attention(q, k, v, impl="cudnn")


def reference_params(arch):
    jax = pytest.importorskip("jax")
    from repro.configs import get_smoke_config
    from repro.models import build as ref_build

    cfg = get_smoke_config(arch)
    return cfg, jax.tree.map(np.asarray, ref_build(cfg).init(jax.random.PRNGKey(0)))


class TestConvertAndRegistry:
    @pytest.mark.parametrize("arch", DENSE)
    def test_every_leaf_used_every_parameter_filled(self, arch):
        cfg, params = reference_params(arch)
        model = params_from_reference(params, tconfigs.get_smoke_config(arch), device="cpu")
        named = dict(model.named_parameters())
        n_leaves = 0
        for path, leaf in flatten(params):
            if path.startswith("layers."):
                for i in range(cfg.num_layers):
                    np.testing.assert_array_equal(
                        named[f"layers.{i}.{path[7:]}"].detach().numpy(), leaf[i])
                    n_leaves += 1
            else:
                np.testing.assert_array_equal(named[path].detach().numpy(), leaf)
                n_leaves += 1
        assert n_leaves == len(named)
        assert sum(p.numel() for p in named.values()) == sum(
            a.size for _, a in flatten(params))

    def test_unused_leaf_raises(self):
        _, params = reference_params("llama3.2-1b")
        params = dict(params, extra={"w": np.zeros(3, np.float32)})
        with pytest.raises(ValueError, match="extra.w"):
            params_from_reference(params, tconfigs.get_smoke_config("llama3.2-1b"),
                                  device="cpu")

    def test_unfilled_parameter_raises(self):
        _, params = reference_params("granite-34b")
        params = {k: v for k, v in params.items() if k != "final_norm"}
        with pytest.raises(ValueError, match="final_norm.scale"):
            params_from_reference(params, tconfigs.get_smoke_config("granite-34b"),
                                  device="cpu")

    @pytest.mark.parametrize("arch", DENSE)
    def test_configs_equal_the_reference(self, arch):
        ref = pytest.importorskip("repro.configs")
        for ours, theirs in ((tconfigs.get_config(arch), ref.get_config(arch)),
                             (tconfigs.get_smoke_config(arch), ref.get_smoke_config(arch))):
            assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)

    def test_llama_full_parameter_count(self):
        """1,235,814,400 parameters at the published config (counted on the
        meta device, nothing allocated)."""
        cfg = tconfigs.get_config("llama3.2-1b")
        model = model_class(cfg)(cfg, device="meta")
        assert sum(p.numel() for p in model.parameters()) == 1_235_814_400

    @pytest.mark.parametrize("arch", ["xlstm-125m", "qwen3-moe-235b-a22b", "no-such-arch"])
    def test_other_archs_raise(self, arch):
        """Every arch of the reference resolves (``NOT_PORTED`` is empty);
        a name outside the reference's registry raises."""
        ref = pytest.importorskip("repro.configs")
        assert tconfigs.NOT_PORTED == () and tconfigs.ARCH_IDS == ref.ARCH_IDS
        if arch in ref.ARCH_IDS:
            assert tconfigs.get_config(arch).name == arch
        else:
            with pytest.raises(KeyError, match="unknown arch"):
                tconfigs.get_config(arch)

    def test_other_family_raises(self):
        cfg = tconfigs.get_smoke_config("llama3.2-1b").replace(family="diffusion")
        with pytest.raises(KeyError, match="unknown family"):
            build(cfg, device="cpu")

    def test_build_draws_the_reference_distributions(self):
        cfg = tconfigs.get_smoke_config("qwen2-7b")
        model = build(cfg, device="cpu", seed=3)
        w = model.layers[0].mlp.up.w.detach()
        assert w.abs().max() <= 2 * cfg.d_model**-0.5
        assert abs(w.std().item() - 0.88 * cfg.d_model**-0.5) < 0.1 * cfg.d_model**-0.5
        assert torch.equal(model.layers[1].attn.wq.b, torch.zeros_like(model.layers[1].attn.wq.b))
        assert torch.equal(build(cfg, device="cpu", seed=3).embed.table, model.embed.table)

    def test_build_defaults_to_cuda(self):
        if torch.cuda.is_available():
            pytest.skip("a GPU is present")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build(tconfigs.get_smoke_config("llama3.2-1b"))
