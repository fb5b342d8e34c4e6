"""The sequence-parallel residual and the vocabulary-parallel embedding, head
and loss (``repro_torch.models.pshard``'s ``Split.seq`` and ``Split.vocab``)
on gloo ranks, held to the unsplit products, the one-rank port and the
reference.

- The conjugates on 2 and 4 ranks of ``model``: ``collectives.gather_seq``
  returns every rank's positions and ``scatter_seq``'s backward all-gathers
  the cotangent, both bit for bit; ``gather_seq``'s backward (the float32
  sum of the ranks' cotangents, rounded once) and ``scatter_seq`` (the
  rank's positions of the float32 sum of the partials, rounded once) within
  one bfloat16 rounding of each element of the sums computed here (the
  ring adds in another order). Then the split MLP under ``seq`` (the rank's
  positions in, gathered, the rank's d_ff channels, reduce-scattered)
  against the whole MLP: the output within one bfloat16 rounding of each
  element, the gradients within one rounding of the leaf's largest |g|
  (``test_torch_pshard.py``'s conjugate bounds).
- ``shard_seq`` decides as the reference's ``shard_activations`` pins the
  sequence dim (its spec captured from ``with_sharding_constraint`` on a
  fake mesh), for S of 1, below |model|, not divided by it and divided.
- The vocabulary-parallel pieces on (data 1, model 2), with 6 padded
  columns (real vocab 250 of 256): the embedding's lookups summed over
  ``model`` equal the whole lookup bit for bit (scattered and whole);
  ``layers.vocab_parallel_lm_loss`` against ``chunked_lm_loss`` unsplit, in
  chunks of 16 of 64 positions and unchunked: the loss within 1e-5
  (relative), ``h``'s and the head's gradients within one rounding of
  their largest |g|, the padded columns' gradient 0.
- Training: ``phi-3-vision-4.2b``'s smoke config (the vlm family; dense and
  hybrid are ``test_torch_pshard.py``'s) on (data 2, model 2) from the
  reference's parameters: loss within 1e-3 and every leaf's gradient within
  ``test_torch_train_families.py``'s bounds (4e-2 in L2, 6e-2 of its largest
  |g|) of ``jax.grad`` of the reference on a four-device CPU mesh. The
  checkpointed layer inputs of llama's smoke config hold S/|model| rows.
- Serving llama's smoke config on (data 1, model 2) in heads and sequence
  mode: the greedy tokens of a prefill and four decode steps equal the
  one-rank port's, the logits within ``test_torch_serve_sharded.py``'s
  ATOL/RTOL.
- Bytes: ``SENT`` by ``op@axis`` equals ``analysis.roofline``'s count for
  the vlm's train step, prefill and decode on (data 2, model 2); a split
  prefill and train step send no ``sum_partials@model`` and no gather of
  the table over ``model``.
"""
import os

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import traceback
from collections import Counter

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import ShapeConfig, ShardingConfig
from repro_torch.launch.mesh import AbstractMesh, spawn
from repro_torch.models import pshard

VLM, DENSE = "phi-3-vision-4.2b", "llama3.2-1b"
B, S = 4, 64
TRAIN = ShapeConfig("t", S, B, "train")
#: the vlm leaf's bounds: L2, and of its largest |g|
GRAD_L2, GRAD_MAX = 4e-2, 6e-2
ATOL, RTOL = 6e-2, 2e-2
PROMPT, CAP, GEN = 12, 16, 4
V, REAL, CHUNK = 256, 250, 16


def _ulp(x: np.ndarray) -> np.ndarray:
    """One bfloat16 unit in the last place of each |x| (8 significant bits)."""
    return np.exp2(np.floor(np.log2(np.maximum(np.abs(x), 1e-30))) - 7)


def _tol(g: np.ndarray) -> float:
    return float(np.exp2(-7) * np.abs(g).max())


# ---------------------------------------------------------------------------
# The ranks
# ---------------------------------------------------------------------------


def _conjugates(mesh) -> dict:
    """``gather_seq`` and ``scatter_seq`` on every rank's seeded tensors, and
    the split MLP under ``seq`` against the whole one."""
    from repro_torch.comm import collectives
    from repro_torch.models.layers import MLP

    m, r = mesh.shape["model"], mesh.coords["model"]
    gen = torch.Generator().manual_seed(5)
    xs = torch.randn(m, 2, 8, 16, generator=gen).to(torch.bfloat16)  # each rank's positions
    cs = torch.randn(m, 2, 8 * m, 16, generator=gen).to(torch.bfloat16)  # its cotangent
    ps = torch.randn(m, 2, 8 * m, 16, generator=gen)  # each rank's float32 partial
    gs = torch.randn(m, 2, 8, 16, generator=gen).to(torch.bfloat16)
    out = {}
    x = xs[r].clone().requires_grad_(True)
    y = collectives.gather_seq(x, mesh, "model")
    y.backward(cs[r])
    out["gather"] = (y.detach().float().numpy(), x.grad.float().numpy())
    p = ps[r].clone().requires_grad_(True)
    z = collectives.scatter_seq(p, mesh, "model", torch.bfloat16)
    z.backward(gs[r])
    out["scatter"] = (z.detach().float().numpy(), p.grad.numpy())
    out["inputs"] = (xs.float().numpy(), cs.float().numpy(), ps.numpy(), gs.float().numpy())

    cfg = get_smoke_config(DENSE)
    split = pshard.model_split(cfg, mesh).at(16)
    whole = MLP(cfg.d_model, cfg.d_ff)
    whole.init(torch.Generator().manual_seed(3))
    x0 = torch.randn(2, 16, cfg.d_model, generator=gen).to(torch.bfloat16)
    g0 = torch.randn(2, 16, cfg.d_model, generator=gen).to(torch.bfloat16)
    f, s = split.d_ff, split.seq
    part = MLP(cfg.d_model, f.stop - f.start)
    with torch.no_grad():
        part.gate.w.copy_(whole.gate.w[:, f])
        part.up.w.copy_(whole.up.w[:, f])
        part.down.w.copy_(whole.down.w[f])
    for name, mod, sp, xin, gin in (("whole", whole, None, x0, g0),
                                    ("split", part, split, x0[:, s], g0[:, s])):
        xx = xin.clone().requires_grad_(True)
        yy = mod(xx, sp)
        (yy.float() * gin.float()).sum().backward()
        out[name] = {"y": yy.detach().float().numpy(), "dx": xx.grad.float().numpy(),
                     "gate": mod.gate.w.grad.numpy(), "up": mod.up.w.grad.numpy(),
                     "down": mod.down.w.grad.numpy()}
    out["blocks"] = ((f.start, f.stop), (s.start, s.stop))
    out["index"] = r
    return out


def _vocab_pieces(mesh) -> dict:
    """The vocabulary-parallel embedding and loss on this rank, with the
    whole ones beside them."""
    from repro_torch.models.layers import Embedding, chunked_lm_loss, vocab_parallel_lm_loss

    cfg = get_smoke_config(DENSE).replace(vocab_size=REAL)
    base = pshard.model_split(cfg, mesh)
    gen = torch.Generator().manual_seed(7)
    emb = Embedding(V, cfg.d_model)
    emb.init(gen)
    tokens = torch.randint(0, REAL, (2, S), generator=gen)
    h = torch.randn(2, S, cfg.d_model, generator=gen).to(torch.bfloat16)
    w = torch.randn(cfg.d_model, V, generator=gen) * cfg.d_model ** -0.5
    labels = torch.randint(0, REAL, (2, S), generator=gen)
    out = {"vocab": (base.vocab.start, base.vocab.stop)}
    whole_emb = emb(tokens)
    block = Embedding(V // 2, cfg.d_model)
    with torch.no_grad():
        block.table.copy_(emb.table[base.vocab])
    for S_call in (S, 1):  # scattered over the positions, and summed whole
        split = base.at(S_call)
        got = split.embed(block(tokens[:, :S_call], split.vocab))
        out[f"embed{S_call}"] = (got.detach().float().numpy(),
                                 split.own(whole_emb[:, :S_call]).detach().float().numpy())
    split = base.at(S)
    for chunk in (CHUNK, None):
        hw = h.clone().requires_grad_(True)
        ww = w.clone().requires_grad_(True)
        want = chunked_lm_loss(hw, ww, labels, chunk=chunk, real_vocab=REAL)
        want.backward()
        hs = h[:, split.seq].clone().requires_grad_(True)
        wb = w[:, split.vocab].clone().requires_grad_(True)
        got = vocab_parallel_lm_loss(split.enter(hs, torch.float32), wb, labels, split.vocab,
                                     mesh, chunk=chunk, real_vocab=REAL)
        got.backward()
        out[f"loss{chunk}"] = {
            "loss": (got.item(), want.item()),
            "dh": (hs.grad.float().numpy(), hw.grad[:, split.seq].float().numpy()),
            "dw": (wb.grad.numpy(), ww.grad[:, split.vocab].numpy())}
    return out


def _batch(arch) -> dict:
    from repro_torch.data.synthetic import frontend_stub

    cfg = get_smoke_config(arch)
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    batch.update(frontend_stub(cfg, TRAIN, 0))
    return batch


def _train(arch, params, mesh) -> dict:
    """One rank's loss and backward from the reference's parameters, then the
    step's mean over ``data`` and agreement over ``model``, each leaf
    gathered; the checkpointed layer inputs' shapes; and what the table's
    read sent over ``model``."""
    from repro_torch.comm import collectives
    from repro_torch.models import registry, sharding, stacking
    from repro_torch.train import step as step_mod
    from repro_torch.train.trainer import ReconfigurableTrainer

    cfg = get_smoke_config(arch)
    tr = ReconfigurableTrainer(cfg, TRAIN, mesh, transport="xla")
    tr.init_state(params=params)
    layout = tr._layout
    local = step_mod.local_rows(_batch(arch), mesh)
    saved, table_sent = [], []
    remat, read = stacking.remat, sharding.Layout.read

    def spy_remat(fn, policy):
        inner = remat(fn, policy)
        return lambda first, g, x: (saved.append(tuple(x.shape)), inner(first, g, x))[1]

    def spy_read(self, name, shard, rd=None):
        before = collectives.SENT.get("gather_param@model", 0)
        t = read(self, name, shard, rd)
        if name == "embed.table":
            table_sent.append(collectives.SENT.get("gather_param@model", 0) - before)
        return t

    stacking.remat, sharding.Layout.read = spy_remat, spy_read
    try:
        loss = registry.loss(tr.model, local, batch_split=mesh.shape["data"])
        loss.backward()
    finally:
        stacking.remat, sharding.Layout.read = remat, read
    grads = {n: p.grad for n, p in tr.model.named_parameters()}
    grads = step_mod._mean_auto(grads, mesh, "data", layout)
    grads = step_mod._agree_over(grads, mesh, "model", layout)
    grads = {n: layout.full(n, g).numpy() for n, g in grads.items()}
    mean = float(step_mod._mean_over(loss.detach().reshape(1), mesh, ["data"]))
    return {"loss": mean, "grads": grads, "saved": saved, "table_sent": table_sent,
            "split": repr(pshard.model_split(cfg, mesh).at(S))}


def _greedy(mesh, mode) -> dict:
    """llama's smoke config from seed 0 served on this rank: the greedy
    tokens and logits of a prefill and ``GEN`` decode steps."""
    from repro_torch.models import registry
    from repro_torch.serving import steps as S_

    cfg = get_smoke_config(DENSE)
    model = registry.build(cfg, device="cpu", seed=0, mesh=mesh)
    steps = S_.ServeSteps(model, mesh, ShardingConfig(kv_partition=mode),
                          ShapeConfig("serve", CAP, 2, "decode"))
    tokens = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab_size,
                                                                (2, PROMPT))).long()
    cache, logits = steps.prefill({"tokens": tokens})
    toks, out = [logits.argmax(-1, keepdim=True)], [logits.float().numpy()]
    for _ in range(GEN):
        cache, logits = steps.decode(cache, toks[-1])
        toks.append(logits.argmax(-1, keepdim=True))
        out.append(logits.float().numpy())
    return {"tokens": torch.cat(toks, 1).numpy(), "logits": out, "split": repr(steps.split),
            "row": mesh.coords["data"]}


def _bytes(arch, mesh) -> dict:
    """SENT of the vlm's train step, prefill and decode on this rank."""
    from repro_torch.comm import collectives
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data.synthetic import batches_for
    from repro_torch.serving import steps as S_
    from repro_torch.train.trainer import HostSpec, ReconfigurableTrainer

    cfg = get_smoke_config(arch)
    tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=2, total_steps=50)
    tr = ReconfigurableTrainer(cfg, TRAIN, mesh, tcfg=tcfg, transport="xla",
                               hosts=[HostSpec(0, ["xla"])])
    state = tr.init_state(0)
    out = {}
    collectives.SENT.clear()
    tr.step_fn(state, batches_for(cfg, TRAIN)(0))
    out["train"] = dict(collectives.SENT)
    model = S_.build_sharded(cfg, mesh, ShardingConfig(), seed=0)
    steps = S_.ServeSteps(model, mesh, ShardingConfig(), ShapeConfig("serve", CAP, B, "decode"))
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, PROMPT))).long()}
    f = cfg.frontend
    batch["patches"] = torch.from_numpy(
        rng.standard_normal((B, f.num_positions, f.embed_dim))).to(torch.bfloat16)
    collectives.SENT.clear()
    cache, logits = steps.prefill(batch)
    out["prefill"] = dict(collectives.SENT)
    collectives.SENT.clear()
    steps.decode(cache, logits.argmax(-1, keepdim=True))
    out["decode"] = dict(collectives.SENT)
    return out


def _rank(params: dict) -> dict:
    """Every case on this rank of four (spawn target): its record, or the
    traceback."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh

    cases = {
        "conjugates 2": lambda: _conjugates(make_mesh((2, 2), ("data", "model"), device="cpu")),
        "conjugates 4": lambda: _conjugates(make_mesh((1, 4), ("data", "model"), device="cpu")),
        "vocab": lambda: _vocab_pieces(make_mesh((2, 2), ("data", "model"), device="cpu")),
        "train vlm": lambda: _train(VLM, params[VLM],
                                    make_mesh((2, 2), ("data", "model"), device="cpu")),
        "train dense": lambda: _train(DENSE, params[DENSE],
                                      make_mesh((2, 2), ("data", "model"), device="cpu")),
        "bytes vlm": lambda: _bytes(VLM, make_mesh((2, 2), ("data", "model"), device="cpu")),
    }
    for mode in ("heads", "sequence"):
        cases[f"serve {mode}"] = (lambda mode=mode: _greedy(
            make_mesh((2, 2), ("data", "model"), device="cpu"), mode))
    out = {"rank": dist.get_rank()}
    for name, fn in cases.items():
        try:
            out[name] = fn()
        except Exception:
            out[name] = traceback.format_exc()
    return out


# ---------------------------------------------------------------------------
# Fixtures
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax():
    return pytest.importorskip("jax")


@pytest.fixture(scope="module")
def ref_params(jax):
    from repro.configs import get_smoke_config as ref_config
    from repro.models.registry import build as ref_build

    return {a: jax.tree.map(np.asarray, ref_build(ref_config(a)).init(jax.random.PRNGKey(0)))
            for a in (VLM, DENSE)}


@pytest.fixture(scope="module")
def ranks(ref_params):
    out = spawn("test_torch_seqpar:_rank", 4, backend="gloo", args=(ref_params,), threads=1,
                timeout_s=600.0)
    for r in out:
        for key, val in r.items():
            assert not isinstance(val, str), f"rank {r['rank']}, {key}:\n{val}"
    return out


@pytest.fixture(scope="module")
def reference(jax, ref_params):
    """``jax.value_and_grad`` of the reference's vlm loss on a (data 2, model
    2) CPU mesh, its parameters laid out by its ``param_specs``."""
    from jax.sharding import NamedSharding

    from repro import compat
    from repro.configs import get_smoke_config as ref_config
    from repro.configs.base import ShardingConfig as RefSharding
    from repro.launch.mesh import make_test_mesh
    from repro.models.registry import build as ref_build

    mesh = make_test_mesh((2, 2), ("data", "model"))
    model = ref_build(ref_config(VLM), mesh=mesh)
    specs = model.param_specs(RefSharding())
    with (jax.set_mesh(mesh) if hasattr(jax, "set_mesh") else compat.use_mesh(mesh)):
        params = jax.tree.map(lambda x, s: jax.device_put(x, NamedSharding(mesh, s)),
                              ref_params[VLM], specs)
        batch = {k: jax.numpy.asarray(v) for k, v in _batch(VLM).items()}
        loss, g = jax.jit(jax.value_and_grad(model.loss))(params, batch)
    leaves = jax.tree_util.tree_flatten_with_path(g)[0]
    return float(loss), {".".join(str(k.key) for k in path): np.asarray(w) for path, w in leaves}


# ---------------------------------------------------------------------------
# Tests
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m", [2, 4])
def test_sequence_conjugates_are_exact(ranks, m):
    for r in ranks:
        rec = r[f"conjugates {m}"]
        xs, cs, ps, gs = rec["inputs"]
        idx, per = rec["index"], xs.shape[2]
        y, dx = rec["gather"]
        np.testing.assert_array_equal(y, np.concatenate(list(xs), axis=1))
        np.testing.assert_array_equal(rec["scatter"][1], np.concatenate(list(gs), axis=1))
        for got, parts in ((dx, cs), (rec["scatter"][0], ps)):
            want = torch.from_numpy(parts.sum(0)[:, idx * per:(idx + 1) * per])
            want = want.to(torch.bfloat16).float().numpy()
            assert np.all(np.abs(got - want) <= _ulp(want))
        assert rec["blocks"][1] == (idx * 16 // m, (idx + 1) * 16 // m)


@pytest.mark.parametrize("m", [2, 4])
def test_sequence_split_mlp_equals_the_unsplit_products(ranks, m):
    for r in ranks:
        rec = r[f"conjugates {m}"]
        whole, split = rec["whole"], rec["split"]
        (lo, hi), (s0, s1) = rec["blocks"]
        want_y = whole["y"][:, s0:s1]
        assert np.all(np.abs(split["y"] - want_y) <= _ulp(want_y))
        want_dx = whole["dx"][:, s0:s1]
        np.testing.assert_allclose(split["dx"], want_dx, rtol=0, atol=_tol(whole["dx"]))
        for leaf, part in (("gate", np.s_[:, lo:hi]), ("up", np.s_[:, lo:hi]),
                           ("down", np.s_[lo:hi])):
            want = whole[leaf][part]
            np.testing.assert_allclose(split[leaf], want, rtol=0, atol=_tol(want))


def _ref_seq_spec(monkeypatch, jax, S: int, m: int):
    """The reference's ``shard_activations`` spec of a (8, S, 64) residual on
    a fake (data 2, model m) mesh."""
    from types import SimpleNamespace

    from repro.models import pshard as ref_pshard

    mesh = SimpleNamespace(axis_names=("data", "model"), shape={"data": 2, "model": m})
    monkeypatch.setattr(ref_pshard.compat, "current_mesh", lambda: mesh)
    monkeypatch.setattr(ref_pshard.compat, "axis_is_auto", lambda mesh, a: True)
    monkeypatch.setattr(ref_pshard.compat, "axis_size", lambda mesh, a: mesh.shape[a])
    monkeypatch.setattr(jax.lax, "with_sharding_constraint", lambda x, spec: tuple(spec))
    return ref_pshard.shard_activations(jax.ShapeDtypeStruct((8, S, 64), jax.numpy.bfloat16))


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("S", [1, 2, 3, 6, 64, 2048])
def test_seq_decision_follows_the_reference_rule(jax, monkeypatch, S, m):
    spec = _ref_seq_spec(monkeypatch, jax, S, m)
    want = isinstance(spec, tuple) and spec[1] == "model"
    for r in range(m):
        mesh = AbstractMesh({"data": 2, "model": m}, rank=r)
        seq = pshard.shard_seq(S, mesh)
        assert (seq is not None) == want, (S, m)
        if seq is not None:
            assert seq == slice(r * S // m, (r + 1) * S // m)
        for arch in ("llama3.2-1b", "phi-3-vision-4.2b", "hymba-1.5b"):
            split = pshard.model_split(get_config(arch), mesh).at(S)
            assert split.seq == seq and split.vocab is not None
            assert split.at(1).seq is None  # decode is never split


def test_the_sequence_split_needs_the_vocabulary_split():
    """No fallback: a residual the rule splits, with a vocabulary |model|
    does not divide, raises."""
    mesh = AbstractMesh({"data": 1, "model": 2})
    split = pshard.model_split(get_smoke_config(DENSE), mesh)
    whole_vocab = pshard.Split(mesh, split.cfg, split.heads, split.d_ff, split.d_in)
    assert whole_vocab.at(1).seq is None
    with pytest.raises(ValueError, match="vocabulary split"):
        whole_vocab.at(S)


def test_vocab_parallel_embedding_is_the_whole_lookup(ranks):
    for r in ranks:
        rec = r["vocab"]
        assert rec["vocab"][1] - rec["vocab"][0] == V // 2
        for key in ("embed64", "embed1"):
            got, want = rec[key]
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("chunk", [CHUNK, None])
def test_vocab_parallel_loss_matches_chunked_lm_loss(ranks, chunk):
    for r in ranks:
        rec = r["vocab"][f"loss{chunk}"]
        got, want = rec["loss"]
        assert abs(got - want) <= 1e-5 * abs(want)
        for key in ("dh", "dw"):
            g, w = rec[key]
            np.testing.assert_allclose(g, w, rtol=0, atol=_tol(w), err_msg=key)
        lo, hi = r["vocab"]["vocab"]
        pad = np.arange(lo, hi) >= REAL
        assert not np.any(rec["dw"][0][:, pad])


def test_vlm_loss_and_grads_match_reference_on_the_mesh(ranks, reference):
    from repro_torch import tree as T
    from repro_torch.models.stacking import stack_layers

    want_loss, want = reference
    stacks = {"layers": get_smoke_config(VLM).num_layers}
    for r in ranks:
        rec = r["train vlm"]
        assert "seq=slice(" in rec["split"] and "vocab=slice(" in rec["split"]
        assert abs(rec["loss"] - want_loss) <= 1e-3 * abs(want_loss)
        tree = stack_layers({n: torch.from_numpy(g) for n, g in rec["grads"].items()}, stacks)
        got = {".".join(map(str, p)): g.numpy() for p, g in T.flatten_with_paths(tree)}
        assert sorted(got) == sorted(want)
        for path, w in want.items():
            g = got[path]
            assert np.linalg.norm(g - w) <= GRAD_L2 * np.linalg.norm(w), path
            assert np.abs(g - w).max() <= GRAD_MAX * np.abs(w).max(), path


@pytest.mark.parametrize("case", ["train vlm", "train dense"])
def test_checkpointed_layer_inputs_hold_the_ranks_positions(ranks, case):
    cfg = get_smoke_config(VLM if case == "train vlm" else DENSE)
    for r in ranks:
        rec = r[case]
        assert rec["saved"] and set(rec["saved"]) == {(B // 2, S // 2, cfg.d_model)}
        assert rec["table_sent"] == [0]  # the rank's rows, gathered over data only


@pytest.mark.parametrize("mode", ["heads", "sequence"])
def test_split_serve_greedy_tokens_equal_one_rank(ranks, mode):
    from repro_torch.models import registry
    from repro_torch.serving import steps as S_

    cfg = get_smoke_config(DENSE)
    model = registry.build(cfg, device="cpu", seed=0)
    tokens = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab_size,
                                                                (2, PROMPT))).long()
    cache, logits = model.prefill(tokens)
    cache = S_.fit_cache(cache, registry.cache_shapes(cfg, ShapeConfig("s", CAP, 2, "decode")))
    toks, want = [logits.argmax(-1, keepdim=True)], [logits.float().numpy()]
    for _ in range(GEN):
        cache, logits = model.decode_step(cache, toks[-1])
        toks.append(logits.argmax(-1, keepdim=True))
        want.append(logits.float().numpy())
    want_toks = torch.cat(toks, 1).numpy()
    for r in ranks:
        rec = r[f"serve {mode}"]
        assert "vocab=slice(" in rec["split"]
        assert (rec["split"].startswith("Split(heads=Heads")) == (mode == "heads")
        row = rec["row"]
        np.testing.assert_array_equal(rec["tokens"], want_toks[row:row + 1])
        for got, w in zip(rec["logits"], want):
            np.testing.assert_allclose(got, w[row:row + 1], atol=ATOL, rtol=RTOL)


def test_sent_equals_the_roofline_count(ranks):
    from repro_torch.analysis import roofline
    from repro_torch.configs.base import TrainConfig

    cfg = get_smoke_config(VLM)
    tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=2, total_steps=50)
    for r in ranks:
        rec = r["bytes vlm"]
        mesh = AbstractMesh({"data": 2, "model": 2}, rank=r["rank"])
        want = {"train": roofline.step_collectives(cfg, TRAIN, mesh, tcfg=tcfg),
                "prefill": roofline.step_collectives(cfg, ShapeConfig("p", PROMPT, B, "prefill"),
                                                     mesh),
                "decode": roofline.step_collectives(cfg, ShapeConfig("d", CAP, B, "decode"),
                                                    mesh)}
        for phase, sent in rec.items():
            assert Counter(sent) == want[phase], (r["rank"], phase)
        for phase in ("train", "prefill"):
            assert "sum_partials@model" not in rec[phase]
            assert rec[phase]["gather_seq@model"] > 0
        assert rec["prefill"]["scatter_seq@model"] > 0
        assert rec["train"]["grad_scatter_seq@model"] > 0
        assert rec["decode"]["embed_sum@model"] > 0
        assert rec["decode"]["sum_partials@model"] > 0
        # the last position comes from the last rank of model alone
        assert ("last_row@model" in rec["prefill"]) == (r["rank"] % 2 == 1)
