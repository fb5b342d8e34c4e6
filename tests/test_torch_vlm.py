"""The port's vlm family (phi-3-vision) against the reference's.

``VlmLM`` is the dense model whose prefill takes the frontend's patch
embeddings over the first P token embeddings (the reference's ``_VLM`` row
serves through ``transformer.prefill``, which reads ``batch["patches"]``).
Both packages serve the reference's ``build(cfg).init(PRNGKey(0))``
parameters on ``phi3v-smoke`` (2 layers, 8 patch positions of width 64),
the port's converted by ``params_from_reference``, under ``xla_dense`` and
``pallas`` (on the CPU the port's ``pallas`` slot runs the flash kernel's
plain version, the reference's its Pallas kernel in interpret mode).
Prefill logits and the K/V cache are compared, then three decode steps,
teacher-forced with the reference's greedy tokens.

Inputs (tokens, patches) come from numpy with a seed; both packages get the
same values, the patches rounded to bfloat16 on both sides.

Tolerance: 6e-2 absolute plus 2e-2 relative on logits and cache entries,
as for the dense family (``test_torch_serve.py``): both compute in bfloat16
with float32 softmax and norms, and XLA and ATen round bfloat16 products at
different points, a bfloat16 step or two (2**-7 relative) per layer.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs as tconfigs
from repro_torch.launch import serve
from repro_torch.models.convert import params_from_reference
from repro_torch.models.registry import build, model_class
from repro_torch.models.transformer import DenseLM, VlmLM, grow_cache

ARCH = "phi-3-vision-4.2b"
ATOL, RTOL = 6e-2, 2e-2
B, S, STEPS = 2, 40, 3


@pytest.fixture(scope="module")
def jax():
    return pytest.importorskip("jax")


def close(got: torch.Tensor, want) -> None:
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=ATOL, rtol=RTOL)


def patches_np(cfg, seed=3):
    f = cfg.frontend
    x = np.random.default_rng(seed).standard_normal((B, f.num_positions, f.embed_dim))
    return torch.from_numpy(x.astype(np.float32)).bfloat16()


@pytest.mark.parametrize("impl", ["xla_dense", "pallas"])
def test_prefill_and_decode_match_reference(jax, impl):
    import jax.numpy as jnp

    from repro.configs import get_smoke_config as ref_smoke
    from repro.models import build as ref_build

    ref_cfg = ref_smoke(ARCH).replace(attn_impl=impl)
    ref = ref_build(ref_cfg)
    params = ref.init(jax.random.PRNGKey(0))
    model = params_from_reference(jax.tree.map(np.asarray, params),
                                  tconfigs.get_smoke_config(ARCH).replace(attn_impl=impl),
                                  device="cpu")
    assert isinstance(model, VlmLM) and model.attn_impl == impl

    tokens = np.random.default_rng(7).integers(0, ref_cfg.vocab_size, (B, S)).astype(np.int32)
    patches = patches_np(ref_cfg)
    r_cache, r_logits = jax.jit(ref.prefill)(params, {
        "tokens": jnp.asarray(tokens),
        "patches": jnp.asarray(patches.float().numpy()).astype(jnp.bfloat16)})
    cache, logits = model.prefill(torch.from_numpy(tokens).long(), patches=patches)
    assert logits.shape == (B, ref_cfg.vocab_padded) and logits.dtype == torch.bfloat16
    close(logits, r_logits)
    assert cache["len"] == int(r_cache["len"]) == S
    for name in ("k", "v"):
        assert tuple(cache[name].shape) == r_cache[name].shape
        close(cache[name], r_cache[name])

    pad = [(0, 0)] * 5
    pad[2] = (0, STEPS + 1)
    r_cache = {"k": jnp.pad(r_cache["k"], pad), "v": jnp.pad(r_cache["v"], pad),
               "len": r_cache["len"]}
    cache = model.grow_cache(cache, STEPS + 1)
    decode = jax.jit(ref.decode)
    for _ in range(STEPS):
        tok = jnp.argmax(r_logits, -1)[:, None]
        r_cache, r_logits = decode(params, r_cache, {"tokens": tok})
        cache, logits = model.decode_step(cache, torch.from_numpy(np.array(tok)).long())
        close(logits, r_logits)
    assert cache["len"] == S + STEPS
    close(cache["k"], r_cache["k"])
    close(cache["v"], r_cache["v"])


def test_patches_replace_the_first_positions():
    """The patches stand in for the first P embeddings: patches equal to
    the tokens' own embeddings change nothing, and other patches change the
    first layer's K at the first P positions alone (K depends on its own
    position's input)."""
    cfg = tconfigs.get_smoke_config(ARCH)
    model = build(cfg, device="cpu", seed=1)
    P = cfg.frontend.num_positions
    tokens = torch.arange(P, P + 20).remainder(cfg.vocab_size)[None].expand(B, -1).clone()
    patches = patches_np(cfg)
    cache_p, logits_p = model.prefill(tokens, patches=patches)
    cache_t, logits_t = model.prefill(tokens)
    assert not torch.equal(logits_p, logits_t)
    # patches equal to the tokens' own embeddings change nothing
    same = model.embed(tokens)[:, :P]
    cache_s, logits_s = model.prefill(tokens, patches=same)
    assert torch.equal(logits_s, logits_t) and torch.equal(cache_s["k"], cache_t["k"])
    # the first layer's K at position P on depends on its own token alone
    assert torch.equal(cache_p["k"][0, :, P:], cache_t["k"][0, :, P:])
    assert not torch.equal(cache_p["k"][0, :, :P], cache_t["k"][0, :, :P])


def test_decode_is_the_dense_decode():
    """A vlm model and a dense model holding the same parameters decode
    alike from the same cache."""
    cfg = tconfigs.get_smoke_config(ARCH)
    vlm = build(cfg, device="cpu", seed=2)
    dense = DenseLM(cfg.replace(family="dense"), device="cpu")
    dense.load_state_dict(vlm.state_dict())
    dense.prepare()
    tokens = torch.randint(0, cfg.vocab_size, (B, 12), generator=torch.Generator().manual_seed(0))
    cache, logits = vlm.prefill(tokens, patches=patches_np(cfg))
    tok = logits.argmax(-1, keepdim=True)
    _, a = vlm.decode_step(grow_cache(cache, 2), tok)
    _, b = dense.decode_step(grow_cache(cache, 2), tok)
    assert torch.equal(a, b)


def test_configs_equal_the_reference():
    ref = pytest.importorskip("repro.configs")
    for ours, theirs in ((tconfigs.get_config(ARCH), ref.get_config(ARCH)),
                         (tconfigs.get_smoke_config(ARCH), ref.get_smoke_config(ARCH))):
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)


def test_full_parameter_count():
    """3,822,259,200 parameters at the published config, the count of the
    reference's ``param_shapes()`` (counted on the meta device)."""
    cfg = tconfigs.get_config(ARCH)
    assert cfg.head_dim == 96
    model = model_class(cfg)(cfg, device="meta")
    assert isinstance(model, VlmLM)
    assert sum(p.numel() for p in model.parameters()) == 3_822_259_200


def test_wrong_family_raises():
    with pytest.raises(ValueError, match="vlm family"):
        VlmLM(tconfigs.get_smoke_config("llama3.2-1b"), device="cpu")


def test_launcher_batch_carries_patches():
    """The launcher's batch: the tokens, then the patches, both from one
    generator seeded with 0, the patches (B, 576, 3072) bfloat16 at the
    published config as the reference's launcher builds them."""
    cfg = tconfigs.get_config(ARCH)
    tokens, extra = serve.serve_batch(cfg, 2, 700, torch.device("cpu"))
    assert tokens.shape == (2, 700) and set(extra) == {"patches"}
    assert extra["patches"].shape == (2, 576, 3072) and extra["patches"].dtype == torch.bfloat16
    g = torch.Generator().manual_seed(serve.SEED)
    assert torch.equal(tokens, torch.randint(0, cfg.vocab_size, (2, 700), generator=g))
    assert torch.equal(extra["patches"], torch.randn((2, 576, 3072), generator=g).bfloat16())


@pytest.mark.cuda
def test_flash_kernel_in_the_model_on_card():
    """On the card, the smoke model at head dim 96 (phi-3-vision's width)
    launches the flash kernel once per layer of the prefill, and its logits
    stay within the tolerance of dense attention."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels.flash_attention.flash_attention import flash_attention

    cfg = tconfigs.get_smoke_config(ARCH).replace(head_dim=96, attn_impl="pallas")
    model = build(cfg, device="cuda", seed=4)
    tokens = torch.randint(0, cfg.vocab_size, (B, 300), device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(0))
    patches = patches_np(cfg).cuda()
    n0 = flash_attention.launches
    _, logits = model.prefill(tokens, patches=patches)
    assert flash_attention.launches == n0 + cfg.num_layers
    model.attn_impl = "xla_dense"
    _, logits_d = model.prefill(tokens, patches=patches)
    close(logits.cpu(), logits_d.float().cpu().numpy())
