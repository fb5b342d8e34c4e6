"""The port's moe family (qwen3-moe, dbrx) against the reference's.

- routing: ``route`` on the same float32 input gives the same expert ids and
  gates within 1e-6 (both a float32 product, softmax and top-k; the sums
  round in another order); ``capacity`` and ``_positions_in_expert`` equal;
- dispatch: ``dispatch_grouped`` against ``dispatch_dense`` on both packages
  at a capacity that drops nothing, and against the reference's grouped
  dispatch at one that drops most slots, which pins the port's two index
  quirks (a clamped gather for dropped slots, a scatter of kept slots only);
- ``MoeLM``: prefill, the K/V cache and three teacher-forced decode steps
  against ``repro.models.moe`` on the ``qwen3-moe-smoke`` and ``dbrx-smoke``
  configs (the reference's ``init(PRNGKey(0))`` parameters, converted),
  under ``xla_dense`` and ``pallas``; decode's capacity at B = 2 is 1 a
  expert, so tokens are dropped there, as in the reference;
- the ``MoEDispatch`` chunnel: negotiation by exact capability label, and
  ``configure``.

Inputs come from numpy with a seed; both packages get the same values.

Tolerances: expert outputs and logits are bfloat16 products, 2e-2 absolute
and relative for one MoE layer (XLA and ATen round the bfloat16 einsums'
outputs at different points: a bfloat16 step, 2**-7 relative, or two);
logits and caches of the two-layer models 6e-2 absolute plus 2e-2 relative,
as for the dense family (``test_torch_serve.py``). A near-tie in top-k
routing could flip under such a step and move a token to another expert;
the seeds here were not chosen to avoid one, and none occurs.
"""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch import configs as tconfigs
from repro_torch.comm.moe_dispatch import MoEDispatch, configure
from repro_torch.configs.base import MoEConfig
from repro_torch.core.negotiate import pick_compatible
from repro_torch.core.stack import Select, Stack
from repro_torch.launch import serve
from repro_torch.models import moe as tmoe
from repro_torch.models.convert import params_from_reference
from repro_torch.models.registry import build, model_class
from repro_torch.models.transformer import grow_cache

ARCHS = ["qwen3-moe-235b-a22b", "dbrx-132b"]
ATOL, RTOL = 6e-2, 2e-2
B, S, STEPS = 2, 40, 3
T, D = 96, 64


@pytest.fixture(scope="module")
def jax():
    return pytest.importorskip("jax")


def close(got, want, atol=ATOL, rtol=RTOL) -> None:
    got = (got.detach().float().numpy() if isinstance(got, torch.Tensor)
           else np.asarray(got, np.float32))
    np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=atol, rtol=rtol)


def smoke_pair(arch, **moe_kw):
    """The reference's and the port's smoke config, the MoE config changed
    alike by ``moe_kw``."""
    from repro.configs import get_smoke_config as ref_smoke

    ref_cfg, cfg = ref_smoke(arch), tconfigs.get_smoke_config(arch)
    if moe_kw:
        ref_cfg = ref_cfg.replace(moe=dataclasses.replace(ref_cfg.moe, **moe_kw))
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, **moe_kw))
    return ref_cfg, cfg


def mlp_pair(jax, ref_cfg, cfg, seed=0):
    """The reference's MoE parameters (``moe_mlp_init``) and the port's
    ``MoeMLP`` holding them."""
    from repro.models import moe as rmoe

    p = jax.tree.map(np.asarray, rmoe.moe_mlp_init(jax.random.PRNGKey(seed), ref_cfg))
    m = tmoe.MoeMLP(cfg).requires_grad_(False)
    with torch.no_grad():
        m.router.w.copy_(torch.from_numpy(np.array(p["router"]["w"])))
        for name in ("gate", "up", "down"):
            getattr(m, name).copy_(torch.from_numpy(np.array(p[name])))
    m.prepare()
    return p, m


def tokens_np(seed=1, n=T, scale=1.0):
    x = np.random.default_rng(seed).standard_normal((n, D)) * scale
    return x.astype(np.float32)


class TestRouting:
    @pytest.mark.parametrize("arch", ARCHS)
    def test_route_matches_reference_exactly(self, jax, arch):
        import jax.numpy as jnp
        from repro.models import moe as rmoe

        ref_cfg, cfg = smoke_pair(arch)
        p, m = mlp_pair(jax, ref_cfg, cfg)
        x = tokens_np()
        r_gates, r_ids, r_aux = rmoe.route(p["router"], jnp.asarray(x), ref_cfg)
        gates, ids, aux = tmoe.route(m.router.w, torch.from_numpy(x), cfg)
        np.testing.assert_array_equal(ids.numpy(), np.asarray(r_ids))
        close(gates, r_gates, atol=1e-6, rtol=0)
        close(aux, r_aux, atol=1e-6, rtol=0)
        # slot 0 is the largest gate
        assert bool((gates[:, :-1] >= gates[:, 1:]).all())

    @pytest.mark.parametrize("n", [1, 4, 7, 96, 8192])
    def test_capacity_matches_reference(self, n):
        from repro.configs import get_config as ref_config
        from repro.models import moe as rmoe

        for arch in ARCHS:
            assert tmoe.capacity(n, tconfigs.get_config(arch)) == rmoe.capacity(
                n, ref_config(arch))

    def test_positions_in_expert_match_reference(self, jax):
        import jax.numpy as jnp
        from repro.models import moe as rmoe

        ids = np.random.default_rng(2).integers(0, 8, (T, 2)).astype(np.int32)
        r_pos, r_keep = rmoe._positions_in_expert(jnp.asarray(ids), 8, 20)
        pos, keep = tmoe._positions_in_expert(torch.from_numpy(ids).long(), 8, 20)
        np.testing.assert_array_equal(pos.numpy(), np.asarray(r_pos))
        np.testing.assert_array_equal(keep.numpy(), np.asarray(r_keep))
        assert not bool(keep.all())  # 192 slots over 8 queues of 20: some dropped


class TestDispatch:
    @pytest.mark.parametrize("arch", ARCHS)
    def test_grouped_equals_dense_on_both(self, jax, arch):
        """At a capacity factor of E / k every expert queue holds every
        token, so the capacity dispatch drops nothing and equals the
        oracle, on each package, and the two packages agree."""
        import jax.numpy as jnp
        from repro.models import moe as rmoe

        ref_cfg, cfg = smoke_pair(arch)
        m_ = cfg.moe
        ref_cfg, cfg = smoke_pair(arch, capacity_factor=m_.num_experts / m_.top_k)
        p, m = mlp_pair(jax, ref_cfg, cfg)
        x = torch.from_numpy(tokens_np()).bfloat16()
        jx = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
        y_g, aux_g = tmoe.dispatch_grouped(m, x, cfg)
        y_d, aux_d = tmoe.dispatch_dense(m, x, cfg)
        r_g, r_aux = rmoe.dispatch_grouped(p, jx, ref_cfg)
        r_d, _ = rmoe.dispatch_dense(p, jx, ref_cfg)
        assert y_g.dtype == y_d.dtype == torch.bfloat16 and y_g.shape == (T, D)
        close(y_g, y_d.float().numpy(), atol=2e-2, rtol=2e-2)
        close(r_g, np.asarray(r_d, np.float32), atol=2e-2, rtol=2e-2)
        close(y_g, r_g, atol=2e-2, rtol=2e-2)
        close(y_d, r_d, atol=2e-2, rtol=2e-2)
        assert aux_g == aux_d

    def test_overflow_drops_like_the_reference(self, jax):
        """A capacity factor of 0.25 keeps at most 48 of 192 (token, slot)
        pairs, in queues of C = 6 (8 experts): the dropped slots gather a clamped row
        (position 5 of their expert) weighted by 0, and the kept slots are
        scattered alone. The port agrees with the reference's scatter with
        ``mode="drop"`` and its clamped gather."""
        import jax.numpy as jnp
        from repro.models import moe as rmoe

        ref_cfg, cfg = smoke_pair("qwen3-moe-235b-a22b", capacity_factor=0.25)
        C = tmoe.capacity(T, cfg)
        assert C == rmoe.capacity(T, ref_cfg) == 6
        p, m = mlp_pair(jax, ref_cfg, cfg, seed=5)
        x = torch.from_numpy(tokens_np(seed=6)).bfloat16()
        jx = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
        y, _ = tmoe.dispatch_grouped(m, x, cfg)
        r_y, _ = rmoe.dispatch_grouped(p, jx, ref_cfg)
        close(y, r_y, atol=2e-2, rtol=2e-2)
        # by hand: only kept slots contribute, each its expert's SwiGLU
        gates, ids, _ = tmoe.route(m.router.w, x, cfg)
        pos, keep = tmoe._positions_in_expert(ids, cfg.moe.num_experts, C)
        counts = torch.bincount(ids.reshape(-1), minlength=8)
        assert torch.equal(torch.bincount(ids[keep], minlength=8), counts.clamp(max=C))
        assert bool((pos[~keep] >= C).all()) and int(keep.sum()) <= cfg.moe.num_experts * C
        want = torch.zeros(T, D)
        for t, j in keep.nonzero().tolist():
            e = ids[t, j]
            h = x[t:t + 1]
            a = torch.nn.functional.silu(h @ m.gate16[e]) * (h @ m.up16[e])
            want[t] += gates[t, j] * (a @ m.down16[e]).float()[0]
        close(y, want.numpy(), atol=2e-2, rtol=2e-2)
        assert torch.equal(y[~keep.any(dim=1)], torch.zeros_like(y[~keep.any(dim=1)]))

    def test_select_resolution(self):
        """alltoall and allgather run as grouped without a mesh, on a mesh
        with no ``model`` axis or no ``data`` axis, and on a mesh with both
        where the reference's conditions fail (the global batch does not
        divide the batch axes, ``model`` does not divide the sequence or the
        experts); on a mesh that meets them they dispatch over it
        (``test_torch_moe_sharded.py``)."""
        cfg = tconfigs.get_smoke_config("dbrx-132b")
        m = tmoe.MoeMLP(cfg).requires_grad_(False)
        m.init(torch.Generator().manual_seed(0))
        m.prepare()
        x = torch.from_numpy(tokens_np(n=24)).bfloat16().reshape(2, 12, D)
        grouped, _ = tmoe.moe_ffn(m, x, configure(cfg, "grouped"))

        def mesh_of(**shape):
            return SimpleNamespace(axis_names=tuple(shape), shape=shape)

        meshes = [None, mesh_of(data=2), mesh_of(model=2),
                  mesh_of(data=4, model=2),  # 2 rows over 4
                  mesh_of(data=2, model=5),  # 12 positions, 4 experts over 5
                  mesh_of(data=2, model=8)]  # 4 experts over 8
        for impl in ("alltoall", "allgather"):
            for mesh in meshes:
                y, _ = tmoe.moe_ffn(m, x, configure(cfg, impl), mesh)
                assert torch.equal(y, grouped)
        with pytest.raises(ValueError, match="unknown moe dispatch"):
            tmoe.moe_ffn(m, x, configure(cfg, "ring"))


def reference_model(jax, arch, impl):
    from repro.configs import get_smoke_config as ref_smoke
    from repro.models import build as ref_build

    ref_cfg = ref_smoke(arch).replace(attn_impl=impl)
    ref = ref_build(ref_cfg)
    params = ref.init(jax.random.PRNGKey(0))
    model = params_from_reference(jax.tree.map(np.asarray, params),
                                  tconfigs.get_smoke_config(arch).replace(attn_impl=impl),
                                  device="cpu")
    return ref_cfg, ref, params, model


@pytest.mark.parametrize("impl", ["xla_dense", "pallas"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(jax, arch, impl, monkeypatch):
    import jax.numpy as jnp

    ref_cfg, ref, params, model = reference_model(jax, arch, impl)
    assert isinstance(model, tmoe.MoeLM) and model.attn_impl == impl
    tokens = np.random.default_rng(7).integers(0, ref_cfg.vocab_size, (B, S)).astype(np.int32)
    r_cache, r_logits = jax.jit(ref.prefill)(params, {"tokens": jnp.asarray(tokens)})
    routed, route = [], tmoe.route

    def tap(*args, **kwargs):
        out = route(*args, **kwargs)
        routed.append(out[1])
        return out

    monkeypatch.setattr(tmoe, "route", tap)
    cache, logits = model.prefill(torch.from_numpy(tokens).long())
    monkeypatch.undo()
    assert len(routed) == ref_cfg.num_layers
    assert routed[0].shape == (B * S, ref_cfg.moe.top_k)
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
    cache = grow_cache(cache, STEPS + 1)
    decode = jax.jit(ref.decode)
    for _ in range(STEPS):
        tok = jnp.argmax(r_logits, -1)[:, None]
        r_cache, r_logits = decode(params, r_cache, {"tokens": tok})
        cache, logits = model.decode_step(cache, torch.from_numpy(np.array(tok)).long())
        close(logits, r_logits)
    assert cache["len"] == S + STEPS
    close(cache["k"], r_cache["k"])


def test_every_leaf_used_every_parameter_filled(jax):
    _, _, params, model = reference_model(jax, "qwen3-moe-235b-a22b", "xla_dense")
    params = jax.tree.map(np.asarray, params)
    named = dict(model.named_parameters())
    assert params["layers"]["moe"]["gate"].shape == (2, 8, 64, 96)
    for i in range(2):
        for leaf in ("gate", "up", "down"):
            np.testing.assert_array_equal(named[f"layers.{i}.moe.{leaf}"].detach().numpy(),
                                          params["layers"]["moe"][leaf][i])
        np.testing.assert_array_equal(named[f"layers.{i}.moe.router.w"].detach().numpy(),
                                      params["layers"]["moe"]["router"]["w"][i])
    bad = dict(params, extra={"w": np.zeros(3, np.float32)})
    with pytest.raises(ValueError, match="no parameter in the port"):
        params_from_reference(bad, model.cfg, device="cpu")


class TestMoEDispatchChunnel:
    def test_negotiation_picks_by_exact_label(self):
        """The server prefers alltoall, then grouped; a client that offers
        grouped alone gets grouped, one that offers allgather gets nothing,
        and a label on another axis does not match."""
        server = Stack(Select(MoEDispatch("alltoall"), MoEDispatch("grouped")))
        pick = pick_compatible(server, Stack(MoEDispatch("grouped")).offer(), mode="first")
        assert pick is not None and pick[0].chunnels[0].impl == "grouped"
        pick = pick_compatible(server, Stack(Select(MoEDispatch("allgather"),
                                                    MoEDispatch("alltoall"))).offer(),
                               mode="first")
        assert pick[0].chunnels[0].impl == "alltoall" and pick[1] == 1
        assert pick_compatible(server, Stack(MoEDispatch("allgather")).offer(),
                               mode="first") is None
        assert pick_compatible(server, Stack(MoEDispatch("grouped", axis="data")).offer(),
                               mode="first") is None

    def test_chunnel_matches_reference(self):
        ref = pytest.importorskip("repro.comm.moe_dispatch")
        for impl in ("dense", "grouped", "alltoall", "allgather"):
            ours, theirs = MoEDispatch(impl), ref.MoEDispatch(impl)
            assert ours.name == theirs.name and ours.manual_axes == theirs.manual_axes
            assert ({(c.label, c.mode) for c in ours.capabilities()}
                    == {(c.label, c.mode) for c in theirs.capabilities()})
            assert ours.apply("tree", "state", {}) == ("tree", "state")

    def test_configure(self):
        from repro.comm.moe_dispatch import configure as ref_configure
        from repro.configs import get_config as ref_config

        for impl in ("dense", "grouped", "allgather"):
            ours = configure(tconfigs.get_config("dbrx-132b"), impl)
            assert ours.moe == MoEConfig(**dataclasses.asdict(
                ref_configure(ref_config("dbrx-132b"), impl).moe))
            assert ours.moe.dispatch == impl


def test_configs_equal_the_reference():
    ref = pytest.importorskip("repro.configs")
    for arch in ARCHS:
        for ours, theirs in ((tconfigs.get_config(arch), ref.get_config(arch)),
                             (tconfigs.get_smoke_config(arch), ref.get_smoke_config(arch))):
            assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)


@pytest.mark.parametrize("arch,layers,n", [("qwen3-moe-235b-a22b", 3, 8_708_976_640),
                                           ("qwen3-moe-235b-a22b", None, 235_094_659_072),
                                           ("dbrx-132b", None, 131_596_523_520)])
def test_full_parameter_count(arch, layers, n):
    """The reference's ``param_shapes()`` count at the published config, and
    at the 3 layers that the card serves (counted on the meta device)."""
    cfg = tconfigs.get_config(arch)
    if layers:
        cfg = serve.cut_depth(cfg, layers)
    model = model_class(cfg)(cfg, device="meta")
    assert sum(p.numel() for p in model.parameters()) == n


def test_build_draws_the_reference_distributions():
    cfg = tconfigs.get_smoke_config("dbrx-132b")
    model = build(cfg, device="cpu", seed=3)
    moe = model.layers[1].moe
    E, Dm, Fe = moe.gate.shape
    assert moe.gate.abs().max() <= 2 * Dm**-0.5 and moe.down.abs().max() <= 2 * Fe**-0.5
    assert moe.gate16.dtype == torch.bfloat16 and moe.down16.shape == (E, Fe, Dm)
    assert torch.equal(build(cfg, device="cpu", seed=3).layers[1].moe.up, moe.up)


def test_launcher_cuts_depth(capsys):
    res = serve.main(["--arch", "qwen3-moe-235b-a22b", "--smoke", "--layers", "1", "--device",
                      "cpu", "--batch", "2", "--prompt-len", "16", "--gen", "2"])
    assert res.tokens.shape == (2, 3)
    with pytest.raises(ValueError, match="hybrid"):
        serve.cut_depth(tconfigs.get_config("hymba-1.5b"), 3)
