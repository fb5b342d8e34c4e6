"""The port's hybrid family (hymba) against the reference's.

- ``models/ssm.py``: ``ssm_apply`` and ``ssm_decode`` against the
  reference's on the same parameters (the reference's ``ssm_init`` draws,
  copied by name), at chunk 256 (one chunk) and 8 (five chunks, the state
  carried), with and without an initial state;
- ``HymbaLM``: prefill and three teacher-forced decode steps against
  ``repro.models.hymba`` on ``hymba-smoke`` (4 layers, global layers 0 and 3,
  window 8), under ``xla_dense`` and ``pallas`` (the port's ``pallas`` slot runs
  the flash kernel's plain version on the CPU, the reference's its Pallas
  kernel in interpret mode). The prompt, 40 tokens, is longer than the window,
  so the sliding-window layers' caches are ring-aligned rings of 8;
- the converter, configs, cache layout and the serve launcher.

Inputs come from numpy with a seed; both packages get the same values.

Tolerances, by what is compared:
- bfloat16 tensors (logits, K/V, the conv tail, the SSM branch's output):
  6e-2 absolute plus 2e-2 relative on logits and caches, as for the dense
  family (``test_torch_serve.py``); 1e-2 plus 2e-2 on one SSM branch. XLA
  and ATen round bfloat16 products (and the bfloat16 silu and conv taps) at
  different points, which moves values by a bfloat16 step or two (2**-7
  relative) per layer.
- the float32 SSM state ``h``: 2e-3 absolute plus 2e-2 relative. It is a sum
  of ``dt * x * B`` terms whose bfloat16 factors differ by such a step;
  softplus differs too (PyTorch's is linear above 20, jax's is not), by far
  less than that at these values (dt's input is below 0).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs as tconfigs
from repro_torch.configs.base import SSMConfig
from repro_torch.launch import serve
from repro_torch.models import ssm as tssm
from repro_torch.models.convert import flatten, params_from_reference
from repro_torch.models.hymba import HymbaLM
from repro_torch.models.registry import build, model_class

ARCH = "hymba-1.5b"
ATOL, RTOL = 6e-2, 2e-2
H_TOL = dict(atol=2e-3, rtol=2e-2)
B, S, STEPS = 2, 40, 3


@pytest.fixture(scope="module")
def jax():
    return pytest.importorskip("jax")


def close(got: torch.Tensor, want, atol=ATOL, rtol=RTOL) -> None:
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=atol, rtol=rtol)


def same_dtype(got: torch.Tensor, want) -> None:
    assert str(got.dtype).split(".")[1] == str(want.dtype), (got.dtype, want.dtype)


def close_cache(cache, r_cache) -> None:
    assert cache["len"] == int(r_cache["len"])
    assert len(cache["layers"]) == len(r_cache["layers"])
    for c, rc in zip(cache["layers"], r_cache["layers"]):
        for name in ("k", "v", "ssm_h", "ssm_conv"):
            assert tuple(c[name].shape) == rc[name].shape, name
            same_dtype(c[name], rc[name])
            if name == "ssm_h":
                close(c[name], rc[name], **H_TOL)
            else:
                close(c[name], rc[name])


class TestSSM:
    D = 64

    @pytest.fixture(scope="class", params=[4, 16], ids=["N4", "N16"])
    def pair(self, request, jax):
        """The reference's SSM parameters and the port's module holding them."""
        from repro.configs.base import SSMConfig as RefSSMConfig
        from repro.models import ssm as rssm

        n = request.param
        rs = RefSSMConfig(state_dim=n, conv_dim=4, expand=2)
        p = jax.tree.map(np.asarray, rssm.ssm_init(jax.random.PRNGKey(n), self.D, rs))
        s = SSMConfig(state_dim=n, conv_dim=4, expand=2)
        m = tssm.SSM(self.D, s)
        named = dict(m.named_parameters())
        assert sorted(named) == sorted(path for path, _ in flatten(p))
        with torch.no_grad():
            for path, leaf in flatten(p):
                named[path].copy_(torch.from_numpy(np.array(leaf)))
        for mod in m.modules():
            if hasattr(mod, "prepare"):
                mod.prepare()
        return rssm, rs, p, s, m

    def inputs(self, jax, n, with_state, seed=0, S=S):
        import jax.numpy as jnp

        rng = np.random.default_rng(seed)
        x = torch.from_numpy(rng.standard_normal((B, S, self.D)).astype(np.float32)).bfloat16()
        jx = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
        if not with_state:
            return x, jx, None, None
        h = (rng.standard_normal((B, 2 * self.D, n)) * 0.1).astype(np.float32)
        conv = rng.standard_normal((B, 3, 2 * self.D)).astype(np.float32)
        return x, jx, (torch.from_numpy(h), torch.from_numpy(conv)), (jnp.asarray(h),
                                                                        jnp.asarray(conv))

    @pytest.mark.parametrize("with_state", [False, True], ids=["zero-state", "given-state"])
    @pytest.mark.parametrize("chunk", [256, 8])
    def test_ssm_apply_matches_reference(self, jax, pair, chunk, with_state):
        rssm, rs, p, s, m = pair
        x, jx, st, rst = self.inputs(jax, s.state_dim, with_state)
        with torch.no_grad():
            y, new = tssm.ssm_apply(m, x, s, st and tssm.SSMState(*st), chunk=chunk)
        ry, rnew = jax.jit(lambda p, x, st: rssm.ssm_apply(p, x, rs, st, chunk=chunk))(
            p, jx, rst and rssm.SSMState(*rst))
        assert y.shape == ry.shape
        for got, want in ((y, ry), (new.h, rnew.h), (new.conv, rnew.conv)):
            same_dtype(got, want)
        close(y, ry, atol=1e-2)
        close(new.h, rnew.h, **H_TOL)
        close(new.conv, rnew.conv)

    def test_ssm_decode_matches_reference(self, jax, pair):
        """Three single-token steps from the zero state, each state carried:
        the conv tail starts float32 and comes back bfloat16."""
        rssm, rs, p, s, m = pair
        x, jx, _, _ = self.inputs(jax, s.state_dim, False, seed=1, S=3)
        st, rst = tssm.init_state(B, self.D, s), rssm.init_state(B, self.D, rs)
        same_dtype(st.conv, rst.conv)
        for t in range(3):
            with torch.no_grad():
                y, st = tssm.ssm_decode(m, x[:, t:t + 1], s, st)
            ry, rst = rssm.ssm_decode(p, jx[:, t:t + 1], rs, rst)
            for got, want in ((y, ry), (st.h, rst.h), (st.conv, rst.conv)):
                same_dtype(got, want)
            close(y, ry, atol=1e-2)
            close(st.h, rst.h, **H_TOL)
            close(st.conv, rst.conv)

    def test_impls_and_chunking_agree(self, pair):
        """On CPU tensors both scan impls run the plain version; its chunk
        length (the steps of a and bx it holds at a time) moves no rounding:
        it scans step by step and contracts each step with C in n order."""
        _, _, _, s, m = pair
        x = torch.randn(B, 37, self.D, generator=torch.Generator().manual_seed(0)).bfloat16()
        with torch.no_grad():
            y, st = tssm.ssm_apply(m, x, s, chunk=8)
            y2, st2 = tssm.ssm_apply(m, x, s, chunk=8, impl="jnp")
            y3, st3 = tssm.ssm_apply(m, x, s, chunk=256)
            assert torch.equal(y, y2) and torch.equal(st.h, st2.h)
            assert torch.equal(y3, y) and torch.equal(st3.h, st.h)
            with pytest.raises(ValueError, match="unknown SSM scan impl"):
                tssm.ssm_apply(m, x, s, impl="cuda")


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


def grow_reference(r_cache, cfg, extra):
    import jax.numpy as jnp

    layers = [dict(c) for c in r_cache["layers"]]
    for i in cfg.global_layers:
        for name in ("k", "v"):
            layers[i][name] = jnp.pad(layers[i][name], ((0, 0), (0, extra), (0, 0), (0, 0)))
    return {"layers": layers, "len": r_cache["len"]}


@pytest.mark.parametrize("impl", ["xla_dense", "pallas"])
@pytest.mark.parametrize("prompt", [S, 5], ids=["longer-than-window", "shorter-than-window"])
def test_prefill_and_decode_match_reference(jax, impl, prompt):
    """Prefill logits and every layer's K/V, ssm_h and ssm_conv, then three
    decode steps teacher-forced with the reference's greedy tokens. A prompt
    of 5 < window 8 gives rings of 5 slots, which decode overwrites from
    position 0 on: the reference's quirk, reproduced."""
    import jax.numpy as jnp

    ref_cfg, ref, params, model = reference_model(jax, impl)
    assert isinstance(model, HymbaLM) and model.attn_impl == impl and model.ssm_impl == "pallas"
    tokens = np.random.default_rng(7).integers(0, ref_cfg.vocab_size, (B, prompt))
    tokens = tokens.astype(np.int32)
    r_cache, r_logits = jax.jit(ref.prefill)(params, {"tokens": jnp.asarray(tokens)})
    cache, logits = model.prefill(torch.from_numpy(tokens).long())
    assert logits.shape == (B, ref_cfg.vocab_padded) and logits.dtype == torch.bfloat16
    close(logits, r_logits)
    close_cache(cache, r_cache)
    window = ref_cfg.sliding_window
    assert cache["layers"][1]["k"].shape[1] == min(window, prompt)

    r_cache = grow_reference(r_cache, ref_cfg, STEPS + 1)
    cache = model.grow_cache(cache, STEPS + 1)
    decode = jax.jit(ref.decode)
    for _ in range(STEPS):
        tok = jnp.argmax(r_logits, -1)[:, None]
        r_cache, r_logits = decode(params, r_cache, {"tokens": tok})
        cache, logits = model.decode_step(cache, torch.from_numpy(np.array(tok)).long())
        close(logits, r_logits)
    assert cache["len"] == prompt + STEPS
    close_cache(cache, r_cache)


def test_ring_slots_hold_their_positions():
    """After a prefill of 40 tokens, slot j of a window-8 ring holds the K of
    the position p in 32..39 with p % 8 == j."""
    model = build(tconfigs.get_smoke_config(ARCH), device="cpu", seed=1)
    tokens = torch.randint(0, 256, (1, S), generator=torch.Generator().manual_seed(0))
    cache, _ = model.prefill(tokens)
    full = model.cfg.replace(global_layers=(0, 1, 2, 3))
    model.cfg = full  # every layer global: its cache keeps all 40 positions
    whole, _ = model.prefill(tokens)
    ring, k_all = cache["layers"][1]["k"], whole["layers"][1]["k"]
    assert ring.shape[1] == 8
    for p in range(32, 40):
        assert torch.equal(ring[:, p % 8], k_all[:, p])


def test_grow_cache_grows_global_layers_and_leaves_the_given_cache():
    model = build(tconfigs.get_smoke_config(ARCH), device="cpu", seed=2)
    cache, _ = model.prefill(torch.zeros(2, 12, dtype=torch.long))
    before = [{n: t.clone() for n, t in c.items()} for c in cache["layers"]]
    grown = model.grow_cache(cache, 5)
    assert [c["k"].shape[1] for c in grown["layers"]] == [17, 8, 8, 17]
    model.decode_step(grown, torch.ones(2, 1, dtype=torch.long))
    for c, b in zip(cache["layers"], before):
        assert all(torch.equal(c[n], b[n]) for n in b)
    with pytest.raises(ValueError, match="grow the cache"):
        model.decode_step(cache, torch.ones(2, 1, dtype=torch.long))


def test_init_cache_matches_reference(jax):
    from repro.configs import get_smoke_config as ref_smoke
    from repro.models import hymba as ref_hymba

    for capacity in (5, 17):
        want = ref_hymba.init_cache(ref_smoke(ARCH), 3, capacity)
        got = build(tconfigs.get_smoke_config(ARCH), device="cpu").init_cache(3, capacity)
        assert got["len"] == int(want["len"]) == 0
        for c, w in zip(got["layers"], want["layers"]):
            for name in ("k", "v", "ssm_h", "ssm_conv"):
                assert tuple(c[name].shape) == w[name].shape
                same_dtype(c[name], w[name])
                assert not c[name].any()


def test_every_leaf_used_every_parameter_filled(jax):
    _, _, params, model = reference_model(jax, "xla_dense")
    params = jax.tree.map(np.asarray, params)
    cfg = model.cfg
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
    assert any(".ssm.A_log" in name for name in named)


def test_configs_equal_the_reference():
    ref = pytest.importorskip("repro.configs")
    for ours, theirs in ((tconfigs.get_config(ARCH), ref.get_config(ARCH)),
                         (tconfigs.get_smoke_config(ARCH), ref.get_smoke_config(ARCH))):
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)


def test_full_parameter_count():
    """1,663,080,000 parameters at the published config, the count of the
    reference's ``param_shapes()`` (counted on the meta device)."""
    cfg = tconfigs.get_config(ARCH)
    model = model_class(cfg)(cfg, device="meta")
    assert sum(p.numel() for p in model.parameters()) == 1_663_080_000


def test_build_draws_the_reference_distributions():
    """A decays below 1 (A_log = log 1..N, dt in [1e-3, 1e-1]), D = 1, conv
    taps truncated at 2 * 0.2, and the same seed gives the same model."""
    cfg = tconfigs.get_smoke_config(ARCH)
    model = build(cfg, device="cpu", seed=3)
    p = model.layers[2].ssm
    n = cfg.ssm.state_dim
    assert torch.equal(p.A_log, torch.log(torch.arange(1, n + 1.0)).expand_as(p.A_log))
    assert torch.equal(p.D, torch.ones_like(p.D)) and not p.conv_b.any()
    dt = torch.nn.functional.softplus(p.dt_bias)
    assert dt.min() >= 1e-3 * (1 - 1e-5) and dt.max() <= 1e-1 * (1 + 1e-5)
    assert p.conv_w.abs().max() <= 0.4
    assert torch.equal(build(cfg, device="cpu", seed=3).layers[2].ssm.dt_bias, p.dt_bias)


def test_wrong_family_raises():
    with pytest.raises(ValueError, match="hybrid family"):
        HymbaLM(tconfigs.get_smoke_config("llama3.2-1b"), device="cpu")


@pytest.mark.cuda
def test_kernels_in_the_model_on_card():
    """On the card, the smoke model's prefill and a decode step launch the
    fused scan kernel once per layer each (300 tokens in one launch), the
    chunk kernel never, and give the very logits of the scan's plain version
    (the kernel is bit-equal to it); the flash kernel stays within the
    serving tolerance of dense attention."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels.ssm_scan.ssm_scan import selective_scan, ssm_scan_chunk

    cfg = tconfigs.get_smoke_config(ARCH).replace(attn_impl="pallas")
    model = build(cfg, device="cuda", seed=4)
    tokens = torch.randint(0, cfg.vocab_size, (B, 300), device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(0))
    n0, c0 = selective_scan.launches, ssm_scan_chunk.launches
    cache, logits = model.prefill(tokens)
    assert selective_scan.launches == n0 + cfg.num_layers
    _, step = model.decode_step(model.grow_cache(cache, 1), tokens[:, :1])
    assert selective_scan.launches == n0 + 2 * cfg.num_layers
    model.ssm_impl = "jnp"
    cache_p, logits_p = model.prefill(tokens)
    _, step_p = model.decode_step(model.grow_cache(cache_p, 1), tokens[:, :1])
    assert selective_scan.launches == n0 + 2 * cfg.num_layers
    assert ssm_scan_chunk.launches == c0
    assert torch.equal(logits, logits_p) and torch.equal(step, step_p)
    model.attn_impl = "xla_dense"
    _, logits_d = model.prefill(tokens)
    close(logits.cpu(), logits_d.float().cpu().numpy())


def test_launcher_runs_on_cpu(capsys):
    res = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith(f"arch={ARCH.replace('1.5b', 'smoke')} attn=pallas device=cpu "
                           "prefill(4x64)=")
    assert "ms/tok first row: [" in line
    assert res.tokens.shape == (4, 17) and bool(torch.isfinite(res.logits).all())
