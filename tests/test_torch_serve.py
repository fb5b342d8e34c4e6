"""The port's serving path against the reference's, on the four dense smoke
configs, each with attention by ``xla_dense`` and by ``pallas`` (on the CPU
the port's ``pallas`` slot runs the flash kernel's plain version, the
reference's runs its Pallas kernel in interpret mode); and the launcher on
every family's smoke config, with the batch the reference's launcher builds
(``patches`` for vlm, ``frames`` for audio). The other families' parity is
in ``test_torch_{hymba,vlm,moe,xlstm,encdec}.py``.

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

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.launch import serve
from repro_torch.models.convert import params_from_reference
from repro_torch.configs.base import ShapeConfig
from repro_torch.models import registry
from repro_torch.models.registry import build
from repro_torch.models.transformer import grow_cache

DENSE = ["llama3.2-1b", "qwen2-7b", "mistral-nemo-12b", "granite-34b"]
#: the families this launcher serves beside dense and hybrid
OTHERS = ["phi-3-vision-4.2b", "qwen3-moe-235b-a22b", "dbrx-132b", "xlstm-125m",
          "seamless-m4t-medium"]
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


@pytest.mark.parametrize("arch", OTHERS)
def test_launcher_runs_other_families_on_cpu(arch, capsys):
    res = serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--batch", "2",
                      "--prompt-len", "32", "--gen", "4"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith(f"arch={get_smoke_config(arch).name} attn=pallas device=cpu "
                           "prefill(2x32)=")
    assert "ms/tok first row: [" in line
    assert res.tokens.shape == (2, 5) and bool(torch.isfinite(res.logits).all())
    args = ["--arch", arch, "--smoke", "--device", "cpu", "--batch", "2", "--prompt-len", "24",
            "--gen", "3"]
    assert torch.equal(serve.main(args).tokens, serve.main(args).tokens)


@pytest.mark.parametrize("arch", DENSE + ["hymba-1.5b"] + OTHERS)
def test_launcher_batch_is_the_references(arch, jax):
    """The launcher's prefill inputs have the names, shapes and dtypes of the
    reference's batch specs (``Model.batch_specs`` of a prefill shape, whose
    vlm batch carries ``patches`` and audio batch ``frames``), at the
    published config; ``serve_batch_specs`` is that table for every shape
    kind."""
    from repro.configs import get_config as ref_config
    from repro.configs.base import ShapeConfig as RefShape
    from repro.models import build as ref_build

    ref_model, cfg = ref_build(ref_config(arch)), get_config(arch)
    for kind in ("prefill", "train", "decode"):
        want = ref_model.batch_specs(RefShape("s", 64, 2, kind))
        got = registry.serve_batch_specs(cfg, ShapeConfig("s", 64, 2, kind))
        assert {k: (tuple(v.shape), str(v.dtype)) for k, v in want.items()} == {
            k: (shp, str(dt).removeprefix("torch.")) for k, (shp, dt) in got.items()}
    tokens, extra = serve.serve_batch(cfg, 2, 64, torch.device("cpu"))
    want = registry.serve_batch_specs(cfg, ShapeConfig("s", 64, 2, "prefill"))
    assert tokens.shape == want["tokens"][0]
    assert {k: (tuple(t.shape), t.dtype) for k, t in extra.items()} == {
        k: v for k, v in want.items() if k not in ("tokens", "labels")}


@pytest.mark.parametrize("arch", OTHERS)
def test_other_families_build_but_do_not_train(arch):
    """``registry.build`` builds every family; the loss and the training
    batch of the four serving-only families raise until their training is
    ported (ROADMAP §A item 7b), and so do the training forward they inherit
    from ``DenseLM`` (``loss``, ``hidden_states``) when called directly."""
    cfg = get_smoke_config(arch)
    model = build(cfg, device="cpu", seed=0)
    assert type(model).FAMILY == cfg.family
    tokens = torch.zeros(2, 8, dtype=torch.long)
    batch = {"tokens": tokens, "labels": tokens}
    if cfg.family == "vlm":
        batch["patches"] = torch.zeros(2, cfg.frontend.num_positions, cfg.frontend.embed_dim)
    with pytest.raises(KeyError, match="not ported"):
        registry.loss(model, batch)
    model.release()
    with pytest.raises(NotImplementedError, match="7b"):
        model.loss(batch)
    with pytest.raises(NotImplementedError, match="7b"):
        model.hidden_states(tokens)
    with pytest.raises(KeyError, match="not ported"):
        registry.batch_specs(cfg, ShapeConfig("s", 8, 2, "train"))
    assert cfg.family not in registry.TRAINED


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
