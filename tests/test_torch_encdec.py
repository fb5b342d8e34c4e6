"""The port's audio family (seamless-m4t, encoder-decoder) against the
reference's.

Both serve the reference's ``build(cfg).init(PRNGKey(0))`` parameters on
``seamless-smoke`` (2 encoder and 2 decoder layers, layernorm, frames of
width 64), the port's converted by ``params_from_reference`` (the encoder
and decoder stacks split by layer), under ``xla_dense`` and ``pallas`` (on
the CPU the port's ``pallas`` slot runs the flash kernel's plain version,
the reference's its Pallas kernel in interpret mode; the encoder and the
cross attention are non-causal, the cross attention with Sq = S and
Skv = S / 4). Prefill logits and every cache leaf (``k``, ``v``, ``xk``,
``xv``) are compared, then three decode steps teacher-forced with the
reference's greedy tokens, after both caches grew as the reference's
launcher grows them: every leaf of rank 4 or more by ``gen + 1`` positions,
the cross caches too. ``test_decode_attends_the_padded_cross_keys`` pins
that quirk: decode reads those zero keys, and a cache whose cross keys did
not grow decodes otherwise.

Inputs (tokens, frames) come from numpy with a seed; both packages get the
same values, the frames rounded to bfloat16 on both sides.

Tolerance: 6e-2 absolute plus 2e-2 relative on logits and cache entries,
as for the dense family (``test_torch_serve.py``): bfloat16 products with
float32 softmax and norms, rounded at different points by XLA and ATen, a
bfloat16 step or two (2**-7 relative) per layer of the four.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs as tconfigs
from repro_torch.launch import serve
from repro_torch.models.convert import flatten, params_from_reference
from repro_torch.models.encdec import CACHE_KEYS, EncDecLM
from repro_torch.models.registry import build, model_class, param_shapes

ARCH = "seamless-m4t-medium"
ATOL, RTOL = 6e-2, 2e-2
B, S, STEPS = 2, 40, 3


@pytest.fixture(scope="module")
def jax():
    return pytest.importorskip("jax")


def close(got: torch.Tensor, want) -> None:
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=ATOL, rtol=RTOL)


def frames_np(cfg, seed=3, S_=S):
    x = np.random.default_rng(seed).standard_normal(
        (B, max(1, S_ // cfg.encdec.src_ratio), cfg.frontend.embed_dim))
    return torch.from_numpy(x.astype(np.float32)).bfloat16()


def reference_model(jax, impl):
    from repro.configs import get_smoke_config as ref_smoke
    from repro.models import build as ref_build

    ref_cfg = ref_smoke(ARCH).replace(attn_impl=impl)
    ref = ref_build(ref_cfg)
    params = ref.init(jax.random.PRNGKey(0))
    model = params_from_reference(jax.tree.map(np.asarray, params),
                                  tconfigs.get_smoke_config(ARCH).replace(attn_impl=impl),
                                  device="cpu")
    return ref_cfg, ref, params, model


def grow_reference(r_cache, extra):
    """The reference launcher's growth (``src/repro/launch/serve.py``):
    every leaf of rank 4 or more padded on axis -3."""
    import jax.numpy as jnp

    def grow(leaf):
        if leaf.ndim < 4:
            return leaf
        pad = [(0, 0)] * leaf.ndim
        pad[-3] = (0, extra)
        return jnp.pad(leaf, pad)

    return {n: grow(v) for n, v in r_cache.items()}


@pytest.mark.parametrize("impl", ["xla_dense", "pallas"])
def test_prefill_and_decode_match_reference(jax, impl):
    import jax.numpy as jnp

    ref_cfg, ref, params, model = reference_model(jax, impl)
    assert isinstance(model, EncDecLM) and model.attn_impl == impl
    tokens = np.random.default_rng(7).integers(0, ref_cfg.vocab_size, (B, S)).astype(np.int32)
    frames = frames_np(ref_cfg)
    r_cache, r_logits = jax.jit(ref.prefill)(params, {
        "tokens": jnp.asarray(tokens),
        "frames": jnp.asarray(frames.float().numpy()).astype(jnp.bfloat16)})
    cache, logits = model.prefill(torch.from_numpy(tokens).long(), frames)
    assert logits.shape == (B, ref_cfg.vocab_padded) and logits.dtype == torch.bfloat16
    close(logits, r_logits)
    assert cache["len"] == int(r_cache["len"]) == S
    for name in CACHE_KEYS:
        assert tuple(cache[name].shape) == r_cache[name].shape, name
        assert cache[name].dtype == torch.bfloat16
        close(cache[name], r_cache[name])
    assert cache["xk"].shape[2] == S // 4

    r_cache = grow_reference(r_cache, STEPS + 1)
    cache = model.grow_cache(cache, STEPS + 1)
    for name in CACHE_KEYS:
        assert tuple(cache[name].shape) == r_cache[name].shape, name
    decode = jax.jit(ref.decode)
    for _ in range(STEPS):
        tok = jnp.argmax(r_logits, -1)[:, None]
        r_cache, r_logits = decode(params, r_cache, {"tokens": tok})
        cache, logits = model.decode_step(cache, torch.from_numpy(np.array(tok)).long())
        close(logits, r_logits)
    assert cache["len"] == int(r_cache["len"]) == S + STEPS
    for name in CACHE_KEYS:
        close(cache[name], r_cache[name])


def test_decode_attends_the_padded_cross_keys():
    """After the launcher's growth the cross caches hold ``gen + 1`` zero
    rows past the encoder's S / 4, and decode attends to them too (zero
    scores, zero values), which dilutes each cross softmax: the same step
    over a cache whose cross keys kept their S / 4 rows gives other logits.
    ``test_prefill_and_decode_match_reference`` holds the grown path to the
    reference's."""
    cfg = tconfigs.get_smoke_config(ARCH)
    model = build(cfg, device="cpu", seed=1)
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=torch.Generator().manual_seed(2))
    cache, logits = model.prefill(tokens, frames_np(cfg))
    grown = model.grow_cache(cache, STEPS + 1)
    assert grown["xk"].shape[2] == S // 4 + STEPS + 1
    assert not grown["xk"][:, :, S // 4:].any() and not grown["xv"][:, :, S // 4:].any()
    tok = logits.argmax(-1, keepdim=True)
    _, quirk = model.decode_step(grown, tok)
    kept = dict(model.grow_cache(cache, STEPS + 1), xk=cache["xk"], xv=cache["xv"])
    _, plain = model.decode_step(kept, tok)
    assert not torch.equal(quirk, plain)


def test_grow_cache_pads_every_leaf_and_leaves_the_given_cache():
    cfg = tconfigs.get_smoke_config(ARCH)
    model = build(cfg, device="cpu", seed=2)
    cache, _ = model.prefill(torch.zeros(B, 12, dtype=torch.long), frames_np(cfg, S_=12))
    before = {n: cache[n].clone() for n in CACHE_KEYS}
    grown = model.grow_cache(cache, 5)
    assert [grown[n].shape[2] for n in CACHE_KEYS] == [17, 17, 8, 8]
    model.decode_step(grown, torch.ones(B, 1, dtype=torch.long))
    assert all(torch.equal(cache[n], before[n]) for n in CACHE_KEYS)
    with pytest.raises(ValueError, match="grow it"):
        model.decode_step(cache, torch.ones(B, 1, dtype=torch.long))


def test_init_cache_matches_reference(jax):
    from repro.configs import get_smoke_config as ref_smoke
    from repro.models import encdec as ref_encdec

    for capacity in (5, 17):
        want = ref_encdec.init_cache(ref_smoke(ARCH), 3, capacity, max(1, capacity // 4))
        got = build(tconfigs.get_smoke_config(ARCH), device="cpu").init_cache(3, capacity)
        assert got["len"] == int(want["len"]) == 0
        for name in CACHE_KEYS:
            assert tuple(got[name].shape) == want[name].shape
            assert got[name].dtype == torch.bfloat16 and not got[name].any()


def test_tree_has_two_stacks(jax):
    """The port's parameter tree in the reference's layout: ``encoder`` and
    ``decoder`` stacked on their own layer axes, leaf for leaf the
    reference's shapes at the published config."""
    from repro.configs import get_config as ref_config
    from repro.models import build as ref_build

    cfg = tconfigs.get_config(ARCH)
    model = model_class(cfg)(cfg, device="meta")
    assert model.stacks() == {"encoder": 12, "decoder": 12}
    got = {p: tuple(t.shape) for p, t in flatten(param_shapes(model))}
    want = ref_build(ref_config(ARCH)).param_shapes()
    assert got == {p: tuple(leaf.shape) for p, leaf in flatten(want)}
    assert got["decoder.cross_attn.wq.w"] == (12, 1024, 1024)


def test_converter_checks_the_layer_axis(jax):
    _, _, params, model = reference_model(jax, "xla_dense")
    params = jax.tree.map(np.asarray, params)
    params["encoder"]["ln1"]["scale"] = params["encoder"]["ln1"]["scale"][:1]
    with pytest.raises(ValueError, match="want the 2 layers"):
        params_from_reference(params, model.cfg, device="cpu")


def test_configs_equal_the_reference():
    ref = pytest.importorskip("repro.configs")
    for ours, theirs in ((tconfigs.get_config(ARCH), ref.get_config(ARCH)),
                         (tconfigs.get_smoke_config(ARCH), ref.get_smoke_config(ARCH))):
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)


def test_full_parameter_count():
    """978,972,672 parameters at the published config, the count of the
    reference's ``param_shapes()`` (counted on the meta device)."""
    cfg = tconfigs.get_config(ARCH)
    model = model_class(cfg)(cfg, device="meta")
    assert sum(p.numel() for p in model.parameters()) == 978_972_672


def test_launcher_batch_carries_frames():
    """The launcher's batch: the tokens, then the frames (B, S // 4, 1024)
    bfloat16 at the published config, both from one generator seeded with
    0, as the reference's launcher builds them."""
    cfg = tconfigs.get_config(ARCH)
    tokens, extra = serve.serve_batch(cfg, 2, 64, torch.device("cpu"))
    assert tokens.shape == (2, 64) and set(extra) == {"frames"}
    assert extra["frames"].shape == (2, 16, 1024) and extra["frames"].dtype == torch.bfloat16
    g = torch.Generator().manual_seed(serve.SEED)
    torch.randint(0, cfg.vocab_size, (2, 64), generator=g)
    assert torch.equal(extra["frames"], torch.randn((2, 16, 1024), generator=g).bfloat16())


@pytest.mark.cuda
def test_flash_kernel_in_the_model_on_card():
    """On the card, the smoke model's prefill launches the flash kernel three
    times a decoder layer and once an encoder layer (encoder non-causal,
    decoder causal, cross non-causal with Skv = S / 4) and none in decode;
    its logits stay within the tolerance of dense attention."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels.flash_attention.flash_attention import flash_attention

    cfg = tconfigs.get_smoke_config(ARCH).replace(attn_impl="pallas")
    model = build(cfg, device="cuda", seed=4)
    tokens = torch.randint(0, cfg.vocab_size, (B, 256), device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(0))
    frames = frames_np(cfg, S_=256).cuda()
    n0 = flash_attention.launches
    cache, logits = model.prefill(tokens, frames)
    assert flash_attention.launches == n0 + 3 * 2
    model.decode_step(model.grow_cache(cache, 2), tokens[:, :1])
    assert flash_attention.launches == n0 + 3 * 2
    model.attn_impl = "xla_dense"
    _, logits_d = model.prefill(tokens, frames)
    close(logits.cpu(), logits_d.float().cpu().numpy())
