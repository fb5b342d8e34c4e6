"""The compute split over ``model`` (``repro_torch.models.pshard``) on gloo
ranks, held to the unsplit product, the one-rank port and the reference.

- The conjugates on 2 and 4 ranks: an MLP whose ``gate``/``up`` are the
  rank's column blocks and ``down`` its row block, entered through the "f"
  (``Split.enter``) and summed by the "g" (``Split.reduce``), against the
  whole MLP on the same input. The output within one bfloat16 rounding of
  each element (the partials are float32 and the sum rounds once, where
  the whole product rounds once: only the float32 order of the sum
  differs); the gradients of the input and of each block within one
  rounding of the leaf's largest |g| (the input's cotangent is the float32
  sum of the ranks' bfloat16 partial cotangents, where one rank adds
  ``gate``'s and ``up``'s in bfloat16).
- ``shard_heads`` and ``shard_model_dim`` decide as the reference's
  ``shard_heads`` and ``shard_model_dim`` pin (``src/repro/models/pshard.py``,
  their specs captured from ``with_sharding_constraint``) for every arch of
  the zoo at its published widths on ``model`` 2 and 4: the query heads
  split where the reference's q spec names ``model``, the KV heads are the
  rank's block where its k spec does, and the SSM's d_in (and the MLP's
  d_ff) split where its ``shard_model_dim`` does. No ranks: an abstract
  mesh.
- ``llama3.2-1b-smoke`` and ``hymba-smoke`` from the reference's parameters
  on (data 2, model 2) and (data 1, model 2): the loss and every leaf's
  gradient (after the step's mean over ``data`` and agreement over
  ``model``, the blocks gathered) against ``jax.grad`` of the reference's
  loss on a four-device CPU mesh (data 2, model 2), its parameters laid out
  by its ``param_specs``: the loss within 1e-3 (relative), a dense leaf
  within 2e-2 of its largest |g| (``test_torch_train.py``'s bound), a
  hybrid leaf within 4e-2 in L2 and 6e-2 of its largest |g|
  (``test_torch_hymba_train.py``'s). A leaf the split reads as its block
  sends nothing over ``model`` (``gather_param@model``), one it reads whole
  or as a shared part does.
- Both serve on (data 1, model 2) in heads and in sequence mode: prefill
  and three decode steps' logits against the one-rank port and the
  reference at ``test_torch_serve_sharded.py``'s ATOL/RTOL; no working copy
  of a leaf the split consumes is gathered over ``model``; hymba's decode
  sends no ``gather_cache@model``, llama's heads decode no ``all_gather``.
- ``pod2_data2_model4`` (16 ranks): the smoke heads (H 4, KH 2) leave KV
  heads that 4 does not divide, so serving takes sequence mode and keeps
  the attention whole; the MLP and hymba's channels split, and the logits
  hold to the one-rank port.
"""
import os

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import traceback

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import ShapeConfig, ShardingConfig
from repro_torch.launch.mesh import AbstractMesh, spawn
from repro_torch.models import pshard

ARCHS = ("llama3.2-1b", "hymba-1.5b")
ALL_ARCHS = ("qwen2-7b", "granite-34b", "llama3.2-1b", "mistral-nemo-12b", "hymba-1.5b",
             "qwen3-moe-235b-a22b", "dbrx-132b", "xlstm-125m", "seamless-m4t-medium",
             "phi-3-vision-4.2b")
B, S = 4, 64
TRAIN = ShapeConfig("t", S, B, "train")
MESHES = {"data2_model2": ((2, 2), ("data", "model")),
          "data1_model2": ((1, 2), ("data", "model"))}
#: the dense leaf's bound on its largest |g|; the hybrid's L2 and largest |g|
DENSE_MAX, HYBRID_L2, HYBRID_MAX = 2e-2, 4e-2, 6e-2
ATOL, RTOL = 6e-2, 2e-2
MODES = ("heads", "sequence")


# ---------------------------------------------------------------------------
# The ranks
# ---------------------------------------------------------------------------


def _conjugates(mesh) -> dict:
    """The split MLP against the whole one on this rank: outputs and
    gradients, numpy (float32)."""
    from repro_torch.models.layers import MLP

    cfg = get_smoke_config("llama3.2-1b")
    split = pshard.model_split(cfg, mesh)
    gen = torch.Generator().manual_seed(3)
    whole = MLP(cfg.d_model, cfg.d_ff)
    whole.init(gen)
    x0 = torch.randn(2, 8, cfg.d_model, generator=gen).to(torch.bfloat16)
    g0 = torch.randn(2, 8, cfg.d_model, generator=gen).to(torch.bfloat16)
    f = split.d_ff
    part = MLP(cfg.d_model, f.stop - f.start)
    with torch.no_grad():
        part.gate.w.copy_(whole.gate.w[:, f])
        part.up.w.copy_(whole.up.w[:, f])
        part.down.w.copy_(whole.down.w[f])
    out = {}
    for name, mod, sp in (("whole", whole, None), ("split", part, split)):
        x = x0.clone().requires_grad_(True)
        y = mod(x, sp)
        (y.float() * g0.float()).sum().backward()
        out[name] = {"y": y.detach().float().numpy(), "dx": x.grad.float().numpy(),
                     "gate": mod.gate.w.grad.numpy(), "up": mod.up.w.grad.numpy(),
                     "down": mod.down.w.grad.numpy()}
    out["d_ff"] = (f.start, f.stop)
    return out


def _batch(cfg) -> dict:
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _train(arch, params, mesh) -> dict:
    """One rank's loss and backward, then the step's mean over ``data`` and
    agreement over ``model``, each leaf gathered; and what each leaf's read
    sent over ``model``."""
    from repro_torch.comm import collectives
    from repro_torch.models import registry, sharding
    from repro_torch.train import step as step_mod
    from repro_torch.train.trainer import ReconfigurableTrainer

    cfg = get_smoke_config(arch)
    tr = ReconfigurableTrainer(cfg, TRAIN, mesh, transport="xla")
    tr.init_state(params=params)
    model, layout = tr.model, tr._layout
    local = step_mod.local_rows(_batch(cfg), mesh)
    sent_by_leaf: dict = {}
    read = sharding.Layout.read

    def spy(self, name, shard, rd=None):
        before = collectives.SENT.get("gather_param@model", 0)
        t = read(self, name, shard, rd)
        sent_by_leaf[name] = (sent_by_leaf.get(name, 0)
                              + collectives.SENT.get("gather_param@model", 0) - before)
        return t

    sharding.Layout.read = spy
    try:
        loss = registry.loss(model, local, batch_split=mesh.shape["data"])
        loss.backward()
    finally:
        sharding.Layout.read = read
    grads = {n: p.grad for n, p in model.named_parameters()}
    grads = step_mod._mean_auto(grads, mesh, "data", layout)
    grads = step_mod._agree_over(grads, mesh, "model", layout)
    grads = {n: layout.full(n, g).numpy() for n, g in grads.items()}
    mean = float(step_mod._mean_over(loss.detach().reshape(1), mesh, ["data"]))
    split = pshard.model_split(cfg, mesh)
    reads = {n: (r.how if r is not None else "whole")
             for n in grads for r in [split.read_of(n)]}
    return {"loss": mean, "grads": grads, "sent_by_leaf": sent_by_leaf, "reads": reads,
            "model_split": {n: "model" in layout.axes(n) for n in grads}}


def _serve(arch, mode, params, mesh) -> dict:
    """``test_torch_serve_sharded``'s serve case on this mesh, with the
    bytes its layout and its steps sent."""
    import test_torch_serve_sharded as ss

    from repro_torch.comm import collectives
    from repro_torch.models import sharding

    sent_by_leaf: dict = {}
    read = sharding.Layout.read

    def spy(self, name, shard, rd=None):
        before = collectives.SENT.get("gather_param@model", 0)
        t = read(self, name, shard, rd)
        sent_by_leaf[name] = collectives.SENT.get("gather_param@model", 0) - before
        return t

    sharding.Layout.read = spy
    s0 = dict(collectives.SENT)
    try:
        rec = ss._serve_case(arch, mode, params, mesh)
    finally:
        sharding.Layout.read = read
    rec["sent"] = {k: v - s0.get(k, 0) for k, v in collectives.SENT.items()
                   if v > s0.get(k, 0)}
    rec["sent_by_leaf"] = sent_by_leaf
    return rec


def _rank(params: dict, shape, axes, what) -> dict:
    """The cases ``what`` on this rank of a (shape, axes) mesh (spawn
    target): each one's record, or the traceback."""
    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh(shape, axes, device="cpu")
    out = {"coords": dict(mesh.coords)}
    for case in what:
        try:
            kind, *rest = case
            if kind == "conjugates":
                out[case] = _conjugates(mesh)
            elif kind == "train":
                out[case] = _train(rest[0], params[rest[0]], mesh)
            else:
                out[case] = _serve(rest[0], rest[1], params[rest[0]], mesh)
        except Exception:
            out[case] = traceback.format_exc()
    return out


def _spawn(params, shape, axes, what) -> list:
    world = int(np.prod(shape))
    ranks = spawn("test_torch_pshard:_rank", world, backend="gloo",
                  args=(params, shape, axes, what), threads=1, timeout_s=600.0)
    for r, out in enumerate(ranks):
        for key, val in out.items():
            assert not isinstance(val, str), f"rank {r}, {key}:\n{val}"
    return ranks


# ---------------------------------------------------------------------------
# Fixtures
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax():
    return pytest.importorskip("jax")


@pytest.fixture(scope="module")
def ref_params(jax):
    import test_torch_serve_sharded as ss
    from repro.models.registry import build as ref_build

    return {arch: jax.tree.map(np.asarray, ref_build(ss.ref_cfg(arch)).init(
        jax.random.PRNGKey(0))) for arch in ARCHS}


@pytest.fixture(scope="module")
def two_ranks(ref_params):
    what = [("conjugates",)] + [("train", a) for a in ARCHS] + \
        [("serve", a, m) for a in ARCHS for m in MODES]
    return _spawn(ref_params, (1, 2), ("data", "model"), what)


@pytest.fixture(scope="module")
def four_ranks(ref_params):
    return _spawn(ref_params, (2, 2), ("data", "model"),
                  [("train", a) for a in ARCHS])


@pytest.fixture(scope="module")
def model4_ranks(ref_params):
    return _spawn(ref_params, (1, 4), ("data", "model"), [("conjugates",)])


@pytest.fixture(scope="module")
def sixteen_ranks(ref_params):
    return _spawn(ref_params, (2, 2, 4), ("pod", "data", "model"),
                  [("serve", a, "sequence") for a in ARCHS])


@pytest.fixture(scope="module")
def reference(jax, ref_params):
    """``jax.value_and_grad`` of the reference's loss on a (data 2, model 2)
    CPU mesh, its parameters laid out by its ``param_specs``: (loss, the
    gradient's leaves by dotted path)."""
    from jax.sharding import NamedSharding

    from repro import compat
    from repro.configs import get_smoke_config as ref_config
    from repro.configs.base import ShardingConfig as RefSharding
    from repro.launch.mesh import make_test_mesh
    from repro.models.registry import build as ref_build

    mesh = make_test_mesh((2, 2), ("data", "model"))
    out = {}
    for arch in ARCHS:
        model = ref_build(ref_config(arch), mesh=mesh)
        specs = model.param_specs(RefSharding())
        with (jax.set_mesh(mesh) if hasattr(jax, "set_mesh") else compat.use_mesh(mesh)):
            params = jax.tree.map(lambda x, s: jax.device_put(x, NamedSharding(mesh, s)),
                                  ref_params[arch], specs)
            batch = {k: jax.numpy.asarray(v) for k, v in _batch(ref_config(arch)).items()}
            loss, g = jax.jit(jax.value_and_grad(model.loss))(params, batch)
        leaves = jax.tree_util.tree_flatten_with_path(g)[0]
        out[arch] = (float(loss), {".".join(str(k.key) for k in path): np.asarray(w)
                                   for path, w in leaves})
    return out


@pytest.fixture(scope="module")
def one_rank(ref_params):
    """The port on one rank, served as ``test_torch_serve_sharded``'s
    ``one_rank`` fixture serves it."""
    import test_torch_serve_sharded as ss

    from repro_torch.models import registry
    from repro_torch.models.convert import params_from_reference
    from repro_torch.serving import steps as S

    out = {}
    for arch in ARCHS:
        cfg = ss.port_cfg(arch)
        b = ss.batch_np(cfg)
        model = params_from_reference(ref_params[arch], cfg, device="cpu")
        cache, logits = model.prefill(**ss.torch_batch(b))
        cache = S.fit_cache(cache, registry.cache_shapes(cfg, ss.SHAPE))
        rec = {"prefill": logits.float().numpy()}
        for t in range(ss.STEPS):
            cache, logits = model.decode_step(cache, torch.from_numpy(b["next"][:, t:t + 1]).long())
            rec[f"decode{t}"] = logits.float().numpy()
        out[arch] = rec
    return out


@pytest.fixture(scope="module")
def ref_logits(jax, ref_params):
    """The reference's prefill and teacher-forced decode logits (its local
    decode attention)."""
    import jax.numpy as jnp
    import test_torch_serve_sharded as ss
    from repro.configs.base import ShapeConfig as RefShape
    from repro.models.registry import build as ref_build

    out = {}
    for arch in ARCHS:
        cfg = ss.ref_cfg(arch)
        b = ss.batch_np(cfg)
        params = jax.tree.map(jnp.asarray, ref_params[arch])
        model = ref_build(cfg)
        cache, logits = jax.jit(model.prefill)(params, {"tokens": jnp.asarray(b["tokens"])})
        cache = ss._pad_to(cache, model.cache_specs(RefShape("t", ss.CAP, ss.B, "decode")), jnp)
        rec = {"prefill": np.asarray(logits, np.float32)}
        dec = jax.jit(model.decode)
        for t in range(ss.STEPS):
            cache, logits = dec(params, cache, {"tokens": jnp.asarray(b["next"][:, t:t + 1])})
            rec[f"decode{t}"] = np.asarray(logits, np.float32)
        out[arch] = rec
    return out


# ---------------------------------------------------------------------------
# Tests
# ---------------------------------------------------------------------------


def _ulp(x: np.ndarray) -> np.ndarray:
    """One bfloat16 unit in the last place of each |x| (8 significant bits)."""
    return np.exp2(np.floor(np.log2(np.maximum(np.abs(x), 1e-30))) - 7)


@pytest.mark.parametrize("ranks", ["two_ranks", "model4_ranks"])
def test_conjugates_equal_the_unsplit_products(request, ranks):
    for r in request.getfixturevalue(ranks):
        rec = r[("conjugates",)]
        whole, split = rec["whole"], rec["split"]
        assert np.all(np.abs(split["y"] - whole["y"]) <= _ulp(whole["y"]))
        tol = lambda g: np.exp2(-7) * np.abs(g).max()  # noqa: E731
        np.testing.assert_allclose(split["dx"], whole["dx"], rtol=0, atol=tol(whole["dx"]))
        lo, hi = rec["d_ff"]
        for leaf, part in (("gate", np.s_[:, lo:hi]), ("up", np.s_[:, lo:hi]),
                           ("down", np.s_[lo:hi])):
            want = whole[leaf][part]
            np.testing.assert_allclose(split[leaf], want, rtol=0, atol=tol(want))


def _ref_specs(monkeypatch, jax, cfg, m: int) -> dict:
    """The specs the reference's ``shard_heads`` and ``shard_model_dim`` pin
    on q, k, the SSM's xs and an MLP hidden (B, S, d_ff) on (data 2, model m)."""
    from types import SimpleNamespace

    from repro.models import pshard as ref_pshard

    mesh = SimpleNamespace(axis_names=("data", "model"), shape={"data": 2, "model": m})
    monkeypatch.setattr(ref_pshard.compat, "current_mesh", lambda: mesh)
    monkeypatch.setattr(ref_pshard.compat, "axis_is_auto", lambda mesh, a: True)
    monkeypatch.setattr(ref_pshard.compat, "axis_size", lambda mesh, a: mesh.shape[a])
    monkeypatch.setattr(jax.lax, "with_sharding_constraint", lambda x, spec: tuple(spec))
    shape = lambda *s: jax.ShapeDtypeStruct(s, jax.numpy.bfloat16)  # noqa: E731
    hd = cfg.head_dim_
    out = {"q": ref_pshard.shard_heads(shape(8, 16, cfg.num_heads, hd)),
           "k": ref_pshard.shard_heads(shape(8, 16, cfg.num_kv_heads, hd)),
           "d_ff": ref_pshard.shard_model_dim(shape(8, 16, cfg.d_ff), 2)}
    if cfg.ssm is not None:
        out["d_in"] = ref_pshard.shard_model_dim(shape(8, 16, cfg.ssm.expand * cfg.d_model), 2)
    return {k: isinstance(v, tuple) and v[2] == "model" for k, v in out.items()}


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_decisions_follow_the_reference_rules(jax, monkeypatch, arch, m):
    cfg = get_config(arch)
    want = _ref_specs(monkeypatch, jax, cfg, m)
    for r in range(m):
        mesh = AbstractMesh({"data": 2, "model": m}, rank=r)
        heads = pshard.shard_heads(cfg, mesh)
        assert (heads is not None) == want["q"]
        assert (heads is not None and heads.kv_block) == want["k"]
        if heads is not None:
            hl, kl = cfg.num_heads // m, heads.kv.stop - heads.kv.start
            assert heads.q == slice(r * hl, (r + 1) * hl)
            # GQA: the rank's query heads read exactly its KV heads
            group = cfg.num_heads // cfg.num_kv_heads
            assert {h // group for h in range(heads.q.start, heads.q.stop)} == \
                set(range(heads.kv.start, heads.kv.stop))
            assert hl % kl == 0
        assert (pshard.shard_model_dim(cfg.d_ff, mesh) is not None) == want["d_ff"]
        if cfg.ssm is not None:
            assert (pshard.shard_model_dim(cfg.ssm.expand * cfg.d_model, mesh)
                    is not None) == want["d_in"]
        split = pshard.model_split(cfg, mesh)
        assert (split is not None) == (cfg.family in pshard.SPLIT_FAMILIES)
    # and no split on one rank of model, nor in sequence mode's attention
    assert pshard.model_split(cfg, AbstractMesh({"data": 2, "model": 1})) is None
    assert pshard.shard_heads(cfg, AbstractMesh({"data": 2, "model": m}), "sequence") is None


def _tree(arch, grads: dict) -> dict:
    from repro_torch import tree as T
    from repro_torch.models.stacking import stack_layers

    stacks = {"layers": get_smoke_config(arch).num_layers}
    tree = stack_layers({n: torch.from_numpy(g) for n, g in grads.items()}, stacks)
    return {".".join(map(str, path)): g.numpy() for path, g in T.flatten_with_paths(tree)}


@pytest.fixture(scope="module")
def one_rank_grads(ref_params):
    """The port's loss and gradient on one rank, by dotted path."""
    from repro_torch.models.convert import params_from_reference

    out = {}
    for arch in ARCHS:
        cfg = get_smoke_config(arch)
        model = params_from_reference(ref_params[arch], cfg, device="cpu").release()
        loss = model.loss({k: torch.from_numpy(v) for k, v in _batch(cfg).items()})
        loss.backward()
        out[arch] = (loss.item(), _tree(arch, {n: p.grad.numpy()
                                               for n, p in model.named_parameters()}))
    return out


def _close_grads(got: dict, want: dict, hybrid: bool, where) -> None:
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        g = got[path]
        assert g.shape == w.shape, path
        if hybrid:
            assert np.linalg.norm(g - w) <= HYBRID_L2 * np.linalg.norm(w), (path, where)
        bound = HYBRID_MAX if hybrid else DENSE_MAX
        assert np.abs(g - w).max() <= bound * np.abs(w).max(), (path, where)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_loss_and_grads_match_reference_on_the_mesh(request, reference, one_rank_grads,
                                                    arch, mesh):
    """Against the reference on its mesh, and against the port on one rank
    (measured on this batch: up to 1.9e-2 of a dense leaf's largest |g|
    from the reference, 1.0e-2 from one rank; a hybrid leaf 3.4e-2 in L2
    and 4.1e-2 of its largest |g| from the reference, 1.4e-2 and 2.3e-2 from
    one rank)."""
    ranks = request.getfixturevalue("four_ranks" if mesh == "data2_model2" else "two_ranks")
    hybrid = get_smoke_config(arch).family == "hybrid"
    for (want_loss, want), side in ((reference[arch], "reference"),
                                    (one_rank_grads[arch], "one rank")):
        for r in ranks:
            rec = r[("train", arch)]
            assert abs(rec["loss"] - want_loss) <= 1e-3 * abs(want_loss), (side, rec["loss"])
            _close_grads(_tree(arch, rec["grads"]), want, hybrid, (side, r["coords"]))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_split_leaves_send_nothing_over_model(request, arch, mesh):
    """A leaf read as its ``model`` block is gathered over the batch axes
    only; every other leaf that the layout splits over ``model`` is
    gathered there (the ones the split reads whole or in shared parts)."""
    ranks = request.getfixturevalue("four_ranks" if mesh == "data2_model2" else "two_ranks")
    for r in ranks:
        rec = r[("train", arch)]
        blocks = [n for n, how in rec["reads"].items() if how == "block"]
        assert blocks and all(rec["model_split"][n] for n in blocks)
        for n in blocks:
            assert rec["sent_by_leaf"][n] == 0, n
        for n, how in rec["reads"].items():
            if how != "block" and rec["model_split"][n]:
                assert rec["sent_by_leaf"][n] > 0, n
        if get_smoke_config(arch).family == "hybrid":
            assert rec["reads"]["layers.0.ssm.in_proj.w"] == "shared"
            assert rec["reads"]["layers.0.ssm.A_log"] == "block"


def test_model_group_computes_the_same_loss(four_ranks, two_ranks):
    for ranks in (four_ranks, two_ranks):
        for arch in ARCHS:
            assert len({r[("train", arch)]["loss"] for r in ranks}) == 1


KEYS = ["prefill", "decode0", "decode1", "decode2"]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ARCHS)
def test_split_serve_logits_match_one_rank_and_reference(two_ranks, one_rank, ref_logits,
                                                         arch, mode):
    for r in two_ranks:
        rec = r[("serve", arch, mode)]
        assert rec["mode"] == mode
        for key in KEYS:
            np.testing.assert_allclose(rec[key], one_rank[arch][key], atol=ATOL, rtol=RTOL,
                                       err_msg=f"{key} vs one rank")
            np.testing.assert_allclose(rec[key], ref_logits[arch][key], atol=ATOL, rtol=RTOL,
                                       err_msg=f"{key} vs the reference")
    a, b = (r[("serve", arch, mode)] for r in two_ranks)
    for key in KEYS:  # the model group's ranks sum the same partials
        np.testing.assert_array_equal(a[key], b[key])


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ARCHS)
def test_split_serve_sends(two_ranks, arch, mode):
    """What the split serve sends: no ``gather_cache`` (the SSM state and
    the rings stay the rank's slices), no ``all_gather`` of the heads
    branch's output, the row products' sums; and its working copies of the
    leaves it splits gathered over nothing of ``model``."""
    cfg = get_smoke_config(arch)
    for r in two_ranks:
        rec = r[("serve", arch, mode)]
        sent = rec["sent"]
        assert "gather_cache@model" not in sent
        assert "all_gather@model" not in sent
        assert sent["sum_partials@model"] > 0
        assert ("all_reduce_max@model" in sent) == (mode == "sequence")
        mesh = AbstractMesh({"data": 1, "model": 2}, rank=r["coords"]["model"])
        split = pshard.model_split(cfg, mesh, mode)
        assert (split.heads is not None) == (mode == "heads")
        for name, nbytes in rec["sent_by_leaf"].items():
            read = split.read_of(name)
            if read is not None and read.how == "block":
                assert nbytes == 0, name


def test_pod2_data2_model4_serves_with_the_attention_whole(sixteen_ranks, one_rank):
    """(pod 2, data 2, model 4): |model| 4 does not divide the smoke's 2 KV
    heads, so ``auto`` is sequence mode, whose attention stays whole; the
    logits of each rank's row hold to the one-rank port's."""
    for arch in ARCHS:
        cfg = get_smoke_config(arch)
        for r in sixteen_ranks:
            rec = r[("serve", arch, "sequence")]
            c = r["coords"]
            mesh = AbstractMesh({"pod": 2, "data": 2, "model": 4},
                                rank=(c["pod"] * 2 + c["data"]) * 4 + c["model"])
            split = pshard.model_split(cfg, mesh, "sequence")
            assert split.heads is None and split.d_ff is not None
            row = c["pod"] * 2 + c["data"]
            for key in KEYS:
                np.testing.assert_allclose(rec[key], one_rank[arch][key][row:row + 1],
                                           atol=ATOL, rtol=RTOL, err_msg=f"{arch} {key}")
            assert "gather_cache@model" not in rec["sent"]
            # the whole attention's K/V of the rank's positions: every KV head
            assert rec["shapes"][("layers", 0, "k") if cfg.family == "hybrid"
                                 else ("k",)][-2] == cfg.num_kv_heads
