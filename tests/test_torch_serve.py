"""The port's serving path against the reference's, on the four dense smoke
configs, each with attention by ``xla_dense`` and by ``pallas`` (on the CPU
the port's ``pallas`` slot runs the flash kernel's plain version, the
reference's runs its Pallas kernel in interpret mode).

Both serve the reference's ``build(cfg).init(PRNGKey(0))`` parameters, the
port's converted by ``params_from_reference``. Prefill logits and the KV
cache are compared, then three decode steps, teacher-forced with the
reference's greedy tokens so that a bfloat16 tie cannot send the two
sequences apart.

Tolerance: 6e-2 absolute plus 2e-2 relative on logits (magnitude up to about
3) and cache entries. Both compute in bfloat16 with float32 softmax and
norms; XLA and ATen round matrix products at different points, which moves
values by a bfloat16 step or two (2**-7 relative) per layer, and two layers
plus the head compound it.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.launch import serve
from repro_torch.models.convert import params_from_reference
from repro_torch.models.registry import build
from repro_torch.models.transformer import grow_cache

DENSE = ["llama3.2-1b", "qwen2-7b", "mistral-nemo-12b", "granite-34b"]
ATOL, RTOL = 6e-2, 2e-2
B, S, STEPS = 2, 40, 3


@pytest.fixture(scope="module")
def jax():
    return pytest.importorskip("jax")


def close(got: torch.Tensor, want) -> None:
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("impl", ["xla_dense", "pallas"])
@pytest.mark.parametrize("arch", DENSE)
def test_prefill_and_decode_match_reference(jax, arch, impl):
    import jax.numpy as jnp

    from repro.configs import get_smoke_config as ref_smoke
    from repro.models import build as ref_build

    ref_cfg = ref_smoke(arch).replace(attn_impl=impl)
    ref = ref_build(ref_cfg)
    params = ref.init(jax.random.PRNGKey(0))
    model = params_from_reference(jax.tree.map(np.asarray, params),
                                  get_smoke_config(arch).replace(attn_impl=impl), device="cpu")
    assert model.attn_impl == impl

    tokens = np.random.default_rng(7).integers(0, ref_cfg.vocab_size, (B, S)).astype(np.int32)
    r_cache, r_logits = jax.jit(ref.prefill)(params, {"tokens": jnp.asarray(tokens)})
    cache, logits = model.prefill(torch.from_numpy(tokens).long())
    assert logits.shape == (B, ref_cfg.vocab_padded) and logits.dtype == torch.bfloat16
    close(logits, r_logits)
    assert cache["len"] == int(r_cache["len"]) == S
    for name in ("k", "v"):
        assert tuple(cache[name].shape) == r_cache[name].shape
        close(cache[name], r_cache[name])

    # grow both caches by STEPS + 1, as both launchers do
    pad = [(0, 0)] * 5
    pad[2] = (0, STEPS + 1)
    r_cache = {"k": jnp.pad(r_cache["k"], pad), "v": jnp.pad(r_cache["v"], pad),
               "len": r_cache["len"]}
    cache = grow_cache(cache, STEPS + 1)
    decode = jax.jit(ref.decode)
    for _ in range(STEPS):
        tok = jnp.argmax(r_logits, -1)[:, None]
        r_cache, r_logits = decode(params, r_cache, {"tokens": tok})
        cache, logits = model.decode_step(cache, torch.from_numpy(np.array(tok)).long())
        close(logits, r_logits)
    assert cache["len"] == int(r_cache["len"]) == S + STEPS
    close(cache["k"], r_cache["k"])


@pytest.mark.parametrize("arch", DENSE)
def test_launcher_runs_on_cpu(arch, capsys):
    res = serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--batch", "2",
                      "--prompt-len", "32", "--gen", "4"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith(f"arch={arch}-smoke attn=pallas device=cpu prefill(2x32)=")
    assert "ms/tok first row: [" in line
    assert res.tokens.shape == (2, 5) and bool(torch.isfinite(res.logits).all())


def test_launcher_is_deterministic():
    args = ["--smoke", "--device", "cpu", "--batch", "2", "--prompt-len", "24", "--gen", "3"]
    assert torch.equal(serve.main(args).tokens, serve.main(args).tokens)


def test_attention_slot_switches_on_a_built_model():
    """One model, its prefill by the flash slot and by xla_dense."""
    model = build(get_smoke_config("mistral-nemo-12b"), device="cpu", seed=2)
    tokens = torch.randint(0, 256, (2, 50), generator=torch.Generator().manual_seed(0))
    model.attn_impl = "pallas"
    cache_a, logits_a = model.prefill(tokens)
    model.attn_impl = "xla_dense"
    cache_b, logits_b = model.prefill(tokens)
    close(logits_a, logits_b.float().numpy())
    close(cache_a["v"], cache_b["v"].float().numpy())


def test_default_device_raises_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present, so the default device runs")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--smoke"])


def test_init_cache_matches_reference(jax):
    from repro.configs import get_smoke_config as ref_smoke
    from repro.models import transformer as ref_transformer

    for arch in DENSE:
        want = ref_transformer.init_cache(ref_smoke(arch), 3, 17)
        got = build(get_smoke_config(arch), device="cpu").init_cache(3, 17)
        for name in ("k", "v"):
            assert tuple(got[name].shape) == want[name].shape
            assert got[name].dtype == torch.bfloat16 and not got[name].any()
        assert got["len"] == int(want["len"]) == 0


def test_decode_past_capacity_raises():
    model = build(get_smoke_config("llama3.2-1b"), device="cpu", seed=1)
    cache, _ = model.prefill(torch.zeros(1, 4, dtype=torch.long))
    with pytest.raises(ValueError, match="grow it"):
        model.decode_step(cache, torch.zeros(1, 1, dtype=torch.long))
