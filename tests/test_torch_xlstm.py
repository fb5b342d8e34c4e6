"""The port's ssm family (xlstm) against the reference's.

- ``_mlstm_chunk``, ``mlstm_apply`` and ``slstm_apply`` against the
  reference's on the same parameters (the reference's ``mlstm_init`` and
  ``slstm_init`` draws, copied by name) and inputs, with and without a given
  state, at a chunk that divides S and one that leaves a padded tail;
- ``XlstmLM``: prefill logits, every layer's state and three teacher-forced
  decode steps (chunk 1) against ``repro.models.xlstm`` on ``xlstm-smoke``
  (2 layers: mLSTM then sLSTM, chunk 16), the reference's
  ``init(PRNGKey(0))`` parameters converted; prompts of 40 tokens (a padded
  tail) and of 16;
- the state's layout, the converter over the list of layers, the config,
  the parameter count and the launcher.

Inputs come from numpy with a seed; both packages get the same values.

Tolerances, by what is compared:
- float32 arithmetic on the same float32 inputs (one mLSTM chunk): 1e-5,
  the rounding of exp, log-sigmoid and the order of the einsums' sums;
- block outputs (bfloat16, after bfloat16 q/k/v products and the float32
  gate products): 2e-2 absolute and relative, a bfloat16 step or two
  (2**-7) where XLA and ATen round the products differently;
- the float32 states (C, n; c, n, h): 2e-2 absolute plus 2e-2 relative,
  sums of terms whose bfloat16 factors differ by such a step;
- logits of the two-layer model: 6e-2 absolute plus 2e-2 relative, as for
  the dense family (``test_torch_serve.py``).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs as tconfigs
from repro_torch.launch import serve
from repro_torch.models import xlstm as tx
from repro_torch.models.convert import flatten, params_from_reference
from repro_torch.models.layers import Linear
from repro_torch.models.registry import build, model_class, param_shapes

ARCH = "xlstm-125m"
ATOL, RTOL = 6e-2, 2e-2
STATE_TOL = dict(atol=2e-2, rtol=2e-2)
BLOCK_TOL = dict(atol=2e-2, rtol=2e-2)
B, S, STEPS = 2, 40, 3


@pytest.fixture(scope="module")
def jax():
    return pytest.importorskip("jax")


def close(got, want, atol=ATOL, rtol=RTOL) -> None:
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=atol, rtol=rtol)


def close_states(got: list, want: list) -> None:
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for name in g:
            assert tuple(g[name].shape) == w[name].shape and g[name].dtype == torch.float32
            close(g[name], w[name], **STATE_TOL)


def copy_into(module: torch.nn.Module, p) -> None:
    named = dict(module.named_parameters())
    assert sorted(named) == sorted(path for path, _ in flatten(p))
    with torch.no_grad():
        for path, leaf in flatten(p):
            named[path].copy_(torch.from_numpy(np.array(leaf)))
    for m in module.modules():
        if hasattr(m, "prepare"):
            m.prepare()
    module.requires_grad_(False)


def smoke_cfgs():
    from repro.configs import get_smoke_config as ref_smoke

    return ref_smoke(ARCH), tconfigs.get_smoke_config(ARCH)


def x_np(seed, S_=S, D=64):
    x = np.random.default_rng(seed).standard_normal((B, S_, D)).astype(np.float32)
    return torch.from_numpy(x).bfloat16()


def to_jax(t):
    import jax.numpy as jnp

    return jnp.asarray(t.float().numpy()).astype(
        jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32)


class TestBlocks:
    def test_mlstm_chunk_matches_reference(self, jax):
        from repro.models import xlstm as rx

        rng = np.random.default_rng(0)
        Bn, C, H, hd = 2, 12, 3, 8
        q, k, v = (rng.standard_normal((Bn, C, H, hd)).astype(np.float32) for _ in range(3))
        i = 1 / (1 + np.exp(-rng.standard_normal((Bn, C, H)))).astype(np.float32)
        logf = -np.log1p(np.exp(-rng.standard_normal((Bn, C, H)))).astype(np.float32)
        C0 = rng.standard_normal((Bn, H, hd, hd)).astype(np.float32) * 0.1
        n0 = rng.standard_normal((Bn, H, hd)).astype(np.float32) * 0.1
        args = (q, k, v, i.astype(np.float32), logf.astype(np.float32), C0, n0)
        want = rx._mlstm_chunk(*args)
        got = tx._mlstm_chunk(*(torch.from_numpy(a) for a in args))
        for g, w in zip(got, want):
            assert tuple(g.shape) == w.shape and g.dtype == torch.float32
            close(g, w, atol=1e-5, rtol=1e-5)

    @pytest.mark.parametrize("with_state", [False, True], ids=["zero-state", "given-state"])
    @pytest.mark.parametrize("chunk", [8, 16], ids=["chunk8-even", "chunk16-padded"])
    def test_mlstm_apply_matches_reference(self, jax, chunk, with_state):
        from repro.models import xlstm as rx

        ref_cfg, cfg = smoke_cfgs()
        p = jax.tree.map(np.asarray, rx.mlstm_init(jax.random.PRNGKey(1), ref_cfg))
        m = tx.MLSTM(cfg)
        copy_into(m, p)
        x = x_np(2)
        st = rst = None
        if with_state:
            rng = np.random.default_rng(3)
            H, hd = cfg.num_heads, cfg.head_dim_
            st = {"C": rng.standard_normal((B, H, hd, hd)).astype(np.float32) * 0.1,
                  "n": rng.standard_normal((B, H, hd)).astype(np.float32) * 0.1}
            rst = {k_: to_jax(torch.from_numpy(v)) for k_, v in st.items()}
            st = {k_: torch.from_numpy(v) for k_, v in st.items()}
        y, new = tx.mlstm_apply(m, x, cfg, st, chunk=chunk)
        ry, rnew = jax.jit(lambda p, x, s: rx.mlstm_apply(p, x, ref_cfg, s, chunk=chunk))(
            p, to_jax(x), rst)
        assert y.dtype == torch.bfloat16 and y.shape == ry.shape
        close(y, ry, **BLOCK_TOL)
        close_states([new], [rnew])

    @pytest.mark.parametrize("with_state", [False, True], ids=["zero-state", "given-state"])
    def test_slstm_apply_matches_reference(self, jax, with_state):
        from repro.models import xlstm as rx

        ref_cfg, cfg = smoke_cfgs()
        p = jax.tree.map(np.asarray, rx.slstm_init(jax.random.PRNGKey(4), ref_cfg))
        m = tx.SLSTM(cfg)
        copy_into(m, p)
        x = x_np(5, S_=24)
        st = rst = None
        if with_state:
            rng = np.random.default_rng(6)
            st = {"c": rng.standard_normal((B, 64)), "n": 1 + rng.random((B, 64)),
                  "h": rng.standard_normal((B, 64)) * 0.1}
            st = {k_: torch.from_numpy(v.astype(np.float32)) for k_, v in st.items()}
            rst = {k_: to_jax(v) for k_, v in st.items()}
        y, new = tx.slstm_apply(m, x, cfg, st)
        ry, rnew = jax.jit(lambda p, x, s: rx.slstm_apply(p, x, ref_cfg, s))(p, to_jax(x), rst)
        close(y, ry, **BLOCK_TOL)
        close_states([new], [rnew])

    def test_float32_linear_path(self):
        """``Linear(x, dtype=float32)`` multiplies the float32 weight in
        float32 (the reference's ``linear(..., dtype=jnp.float32)``), not
        through the bfloat16 copy."""
        lin = Linear(8, 5, bias=True)
        lin.init(torch.Generator().manual_seed(0))
        with torch.no_grad():
            lin.b.copy_(torch.arange(5.0) / 7)
            lin.prepare()
            x = torch.randn(3, 8, generator=torch.Generator().manual_seed(1)).bfloat16()
            y = lin(x, dtype=torch.float32)
            assert y.dtype == torch.float32
            assert torch.equal(y, x.float() @ lin.w + lin.b)
            assert lin(x).dtype == torch.bfloat16


def reference_model(jax):
    from repro.configs import get_smoke_config as ref_smoke
    from repro.models import build as ref_build

    ref = ref_build(ref_smoke(ARCH))
    params = ref.init(jax.random.PRNGKey(0))
    model = params_from_reference(jax.tree.map(np.asarray, params),
                                  tconfigs.get_smoke_config(ARCH), device="cpu")
    return ref, params, model


@pytest.mark.parametrize("prompt", [S, 16], ids=["padded-tail", "one-chunk"])
def test_prefill_and_decode_match_reference(jax, prompt):
    import jax.numpy as jnp

    ref, params, model = reference_model(jax)
    assert isinstance(model, tx.XlstmLM)
    assert [type(layer) for layer in model.layers] == [tx.MLSTM, tx.SLSTM]
    tokens = np.random.default_rng(7).integers(0, 256, (B, prompt)).astype(np.int32)
    r_state, r_logits = jax.jit(ref.prefill)(params, {"tokens": jnp.asarray(tokens)})
    state, logits = model.prefill(torch.from_numpy(tokens).long())
    assert logits.shape == (B, 256) and logits.dtype == torch.bfloat16
    close(logits, r_logits)
    assert state["len"] == int(r_state["len"]) == prompt
    close_states(state["layers"], r_state["layers"])

    assert model.grow_cache(state, STEPS + 1) is state  # no growth
    decode = jax.jit(ref.decode)
    for _ in range(STEPS):
        tok = jnp.argmax(r_logits, -1)[:, None]
        r_state, r_logits = decode(params, r_state, {"tokens": tok})
        state, logits = model.decode_step(state, torch.from_numpy(np.array(tok)).long())
        close(logits, r_logits)
    assert state["len"] == int(r_state["len"]) == prompt + STEPS
    close_states(state["layers"], r_state["layers"])


def test_init_state_matches_reference(jax):
    from repro.configs import get_smoke_config as ref_smoke
    from repro.models import xlstm as rx

    for layers in (2, 5):
        ref_cfg = ref_smoke(ARCH).replace(num_layers=layers)
        cfg = tconfigs.get_smoke_config(ARCH).replace(num_layers=layers)
        want = rx.init_state(ref_cfg, 3)
        got = build(cfg, device="cpu").init_cache(3, 17)
        assert got["len"] == int(want["len"]) == 0
        for g, w in zip(got["layers"], want["layers"]):
            assert sorted(g) == sorted(w)
            for name in g:
                assert tuple(g[name].shape) == w[name].shape and g[name].dtype == torch.float32
                np.testing.assert_array_equal(g[name].numpy(), np.asarray(w[name]))


def test_tree_is_a_list_of_layers(jax):
    """The port's parameter tree in the reference's layout has ``layers`` as
    a list of unlike dicts, leaf for leaf the reference's shapes."""
    from repro.configs import get_config as ref_config
    from repro.models import build as ref_build

    cfg = tconfigs.get_config(ARCH)
    tree = param_shapes(model_class(cfg)(cfg, device="meta"))
    want = ref_build(ref_config(ARCH)).param_shapes()
    assert isinstance(tree["layers"], list) and len(tree["layers"]) == 12
    got = {p: tuple(t.shape) for p, t in flatten(tree)}
    assert got == {p: tuple(leaf.shape) for p, leaf in flatten(want)}
    assert "r" in tree["layers"][1] and "wq" in tree["layers"][0]


def test_converter_rejects_a_stray_leaf(jax):
    _, params, model = reference_model(jax)
    params = jax.tree.map(np.asarray, params)
    params["layers"][0]["extra"] = np.zeros(2, np.float32)
    with pytest.raises(ValueError, match="layers.0.extra"):
        params_from_reference(params, model.cfg, device="cpu")


def test_configs_equal_the_reference():
    ref = pytest.importorskip("repro.configs")
    for ours, theirs in ((tconfigs.get_config(ARCH), ref.get_config(ARCH)),
                         (tconfigs.get_smoke_config(ARCH), ref.get_smoke_config(ARCH))):
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)


def test_full_parameter_count():
    """123,558,192 parameters at the published config, the count of the
    reference's ``param_shapes()`` (counted on the meta device)."""
    cfg = tconfigs.get_config(ARCH)
    model = model_class(cfg)(cfg, device="meta")
    assert sum(p.numel() for p in model.parameters()) == 123_558_192
