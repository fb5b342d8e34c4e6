"""Serving the moe family from the rank's own experts
(``repro_torch.models.moe.dispatch_grouped_ep``), on gloo ranks.

Under a serving split where |model| divides E (``serving.steps.serve_split``
sets ``Split.experts``), each rank's bfloat16 banks hold its ``E/|model|``
experts only, and ``grouped`` runs expert-parallel: every rank of ``model``
routes the same tokens over all E experts at the same capacity, runs its
own experts' slots and sums its float32 partial combine over ``model``.

For ``qwen3-moe-smoke`` (8 experts, top 2) and ``dbrx-smoke`` (4 experts,
top 2) on (data 1, model 2) and (data 2, model 2), from seed 0:

- each layer's bank copies hold ``E/|model|`` experts, and the serve's
  split reads the banks as the rank's block;
- ``moe_ffn`` under the serving split, in decode (one token a row, the
  global batch's tokens routed together where the rows are dealt) and in a
  prefill of the ``grouped`` config (its rows gathered over S), is within
  0.001953125 (absolute) of the whole-bank ``dispatch_grouped`` on the same
  tokens at the same capacity (one bfloat16 rounding of the float32 sum);
- the mesh dispatches on the rank's positions take the rank's banks as
  they are: ``alltoall``'s output is the whole-bank ``dispatch_grouped`` of
  the rank's tokens at their own capacity, ``allgather``'s the rank's block
  of it on its data row's tokens, within ``test_torch_split_serve.py``'s
  bound (2^-7 of the largest |output|: other GEMM shapes, another order of
  the ranks' sum);
- the greedy tokens of a prefill and four decode steps of the ``grouped``
  config through ``ServeSteps`` equal the one-rank port's (whole banks),
  the logits within ``test_torch_serve_sharded.py``'s ATOL/RTOL;
- each rank's ``SENT`` by ``op@axis`` of every decode step (its
  ``sum_partials@model`` the attention's and the expert-parallel
  combine's) equals ``analysis.roofline``'s count.
"""
import traceback
from collections import Counter

import numpy as np
import pytest
import torch

from repro_torch.comm.moe_dispatch import configure
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import ShapeConfig, ShardingConfig
from repro_torch.launch.mesh import AbstractMesh, spawn

ARCHS = ("qwen3-moe-235b-a22b", "dbrx-132b")
#: one bfloat16 rounding at the outputs' magnitude
TOL = 0.001953125
ATOL, RTOL = 6e-2, 2e-2
ROWS, PROMPT, CAP, GEN = 4, 8, 16, 4
MESHES = {"data1": (1, 2), "data2": (2, 2)}


def _prompt(cfg) -> torch.Tensor:
    rng = np.random.default_rng(3)
    return torch.from_numpy(rng.integers(0, cfg.vocab_size, (ROWS, PROMPT))).long()


@torch.no_grad()
def _layer_outputs(arch, mesh) -> dict:
    """The first layer's ``moe_ffn`` under the serving split against the
    whole-bank ``dispatch_grouped`` on the same tokens, decode and prefill."""
    from repro_torch.comm import collectives
    from repro_torch.models import moe as tmoe
    from repro_torch.models import registry
    from repro_torch.serving import steps as S_

    cfg = configure(get_smoke_config(arch), "grouped")
    model = registry.build(cfg, device="cpu", seed=0, mesh=mesh)
    steps = S_.ServeSteps(model, mesh, ShardingConfig(), ShapeConfig("s", CAP, ROWS, "decode"))
    whole = registry.build(cfg, device="cpu", seed=0).layers[0].moe
    p, split = model.layers[0].moe, steps.split
    D = cfg.d_model
    gen = torch.Generator().manual_seed(7)
    out = {"banks": [tuple(layer.moe.gate16.shape) for layer in model.layers],
           "read": split.read_of("layers.0.moe.gate").how}
    n_data, m = mesh.shape["data"], mesh.shape["model"]
    d, r = mesh.coords["data"], mesh.coords["model"]
    rows = ROWS // n_data
    for phase, S in (("decode", 1), ("prefill", PROMPT)):
        x = torch.randn(ROWS, S, D, generator=gen).to(torch.bfloat16)  # the global batch
        want, _ = tmoe.dispatch_grouped(whole, x.reshape(-1, D), cfg)
        want = want.reshape(ROWS, S, D)[d * rows:(d + 1) * rows]
        mine = x[d * rows:(d + 1) * rows]
        at = split.at(S)
        if at.seq is not None:  # the rank's positions of its rows
            per = S // m
            mine, want = (t[:, r * per:(r + 1) * per] for t in (mine, want))
        y, _ = tmoe.moe_ffn(p, mine, cfg, mesh, batch_split=n_data, split=at)
        out[phase] = (y.float().numpy(), want.float().numpy(), at.seq is not None)
    # the mesh dispatches on the rank's positions, on its banks as they are
    x = torch.randn(m, rows, PROMPT // m, D, generator=gen).to(torch.bfloat16)[r]
    y, _ = tmoe.dispatch_alltoall(p, x, cfg, mesh, positions=True, experts=True)
    want, _ = tmoe.dispatch_grouped(whole, x.reshape(-1, D), cfg)
    out["alltoall"] = (y.float().numpy(), want.reshape(y.shape).float().numpy())
    y, _ = tmoe.dispatch_allgather(p, x, cfg, mesh, positions=True, experts=True)
    row = collectives.all_gather(x, mesh, "model").reshape(-1, D)
    want, _ = tmoe.dispatch_grouped(whole, row, cfg)
    out["allgather"] = (y.float().numpy(), want.reshape(m, *y.shape)[r].float().numpy())
    return out


def _greedy(arch, mesh) -> dict:
    from repro_torch.comm import collectives
    from repro_torch.serving import steps as S_

    cfg = configure(get_smoke_config(arch), "grouped")
    model = S_.build_sharded(cfg, mesh, ShardingConfig(), seed=0)
    steps = S_.ServeSteps(model, mesh, ShardingConfig(), ShapeConfig("s", CAP, ROWS, "decode"))
    cache, logits = steps.prefill({"tokens": _prompt(cfg)})
    toks, out = [logits.argmax(-1, keepdim=True)], [logits.float().numpy()]
    sent = []
    for _ in range(GEN):
        collectives.SENT.clear()
        cache, logits = steps.decode(cache, toks[-1])
        sent.append(dict(collectives.SENT))
        toks.append(logits.argmax(-1, keepdim=True))
        out.append(logits.float().numpy())
    return {"tokens": torch.cat(toks, 1).numpy(), "logits": out, "sent": sent,
            "banks": [tuple(layer.moe.gate16.shape) for layer in model.layers],
            "split": repr(steps.split)}


def _rank(mesh_name: str) -> dict:
    """Every case on this rank's mesh (spawn target)."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh(MESHES[mesh_name], ("data", "model"), device="cpu")
    out = {"rank": dist.get_rank(), "coords": dict(mesh.coords)}
    for arch in ARCHS:
        for name, fn in (("layer", _layer_outputs), ("greedy", _greedy)):
            try:
                out[(arch, name)] = fn(arch, mesh)
            except Exception:
                out[(arch, name)] = traceback.format_exc()
    return out


@pytest.fixture(scope="module", params=list(MESHES))
def ranks(request):
    n_data, m = MESHES[request.param]
    out = spawn("test_torch_moe_serve_ep:_rank", n_data * m, backend="gloo",
                args=(request.param,), threads=1, timeout_s=600.0)
    for r in out:
        for key, val in r.items():
            assert not isinstance(val, str), f"rank {r['rank']}, {key}:\n{val}"
    return request.param, out


def _one_rank(arch) -> tuple:
    from repro_torch.models import registry
    from repro_torch.serving import steps as S_

    cfg = configure(get_smoke_config(arch), "grouped")
    model = registry.build(cfg, device="cpu", seed=0)
    cache, logits = model.prefill(_prompt(cfg))
    cache = S_.fit_cache(cache, registry.cache_shapes(cfg, ShapeConfig("s", CAP, ROWS,
                                                                       "decode")))
    toks, out = [logits.argmax(-1, keepdim=True)], [logits.float().numpy()]
    for _ in range(GEN):
        cache, logits = model.decode_step(cache, toks[-1])
        toks.append(logits.argmax(-1, keepdim=True))
        out.append(logits.float().numpy())
    return torch.cat(toks, 1).numpy(), out


@pytest.mark.parametrize("arch", ARCHS)
def test_rank_banks_hold_its_experts(ranks, arch):
    cfg = get_smoke_config(arch)
    _, out = ranks
    E, m = cfg.moe.num_experts, 2
    want = (E // m, cfg.d_model, cfg.moe.d_ff_expert)
    for r in out:
        assert r[(arch, "layer")]["banks"] == [want] * cfg.num_layers
        assert r[(arch, "greedy")]["banks"] == [want] * cfg.num_layers
        assert r[(arch, "layer")]["read"] == "block"
        assert "experts=True" in r[(arch, "greedy")]["split"]


@pytest.mark.parametrize("phase", ["decode", "prefill"])
@pytest.mark.parametrize("arch", ARCHS)
def test_expert_parallel_grouped_equals_whole_bank_grouped(ranks, arch, phase):
    _, out = ranks
    for r in out:
        got, want, seq = r[(arch, "layer")][phase]
        assert seq == (phase == "prefill")
        assert got.shape == want.shape and np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


@pytest.mark.parametrize("impl", ["alltoall", "allgather"])
@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_dispatch_on_the_rank_banks_is_grouped_on_its_tokens(ranks, arch, impl):
    _, out = ranks
    for r in out:
        got, want = r[(arch, "layer")][impl]
        np.testing.assert_allclose(got, want, rtol=0, atol=np.exp2(-7) * np.abs(want).max())


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_tokens_equal_the_whole_bank_serve(ranks, arch):
    name, out = ranks
    want_toks, want = _one_rank(arch)
    rows = ROWS // MESHES[name][0]
    for r in out:
        d = r["coords"]["data"]
        rec = r[(arch, "greedy")]
        np.testing.assert_array_equal(rec["tokens"], want_toks[d * rows:(d + 1) * rows])
        for got, w in zip(rec["logits"], want):
            np.testing.assert_allclose(got, w[d * rows:(d + 1) * rows], atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_bytes_equal_the_roofline_count(ranks, arch):
    from repro_torch.analysis import roofline

    name, out = ranks
    n_data, m = MESHES[name]
    cfg = configure(get_smoke_config(arch), "grouped")
    for r in out:
        mesh = AbstractMesh({"data": n_data, "model": m}, rank=r["rank"])
        want = roofline.step_collectives(cfg, ShapeConfig("d", CAP, ROWS, "decode"), mesh)
        assert want["sum_partials@model"] > 0
        for sent in r[(arch, "greedy")]["sent"]:
            assert Counter(sent) == want
