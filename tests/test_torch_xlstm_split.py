"""xLSTM's blocks split over ``model`` (``repro_torch.models.pshard``): the
mLSTM by heads, the sLSTM by channels and its MLP by its width, in training
and serving, on gloo ranks.

- ``model_split`` on (data 2, model m), m 2 and 4, for ``xlstm-125m``,
  ``xlstm-smoke`` and a smoke variant of ``d_model`` 96 (``WIDE``: 2 heads
  of 48, an sLSTM MLP of 128): which blocks split (heads where m divides H,
  channels where it divides D, the MLP where it divides ``int(D·4/3)``), and
  every leaf that the split reads as the rank's block is the block of the
  reference's ``param_spec`` that names ``model`` on it (``local_slice`` of
  the reference's spec, on the dim it cuts); ``r`` is replicated there and
  read as the rank's columns. ``xlstm-smoke`` at m 4 (H 2) keeps its mLSTM
  whole although the reference's ``wq`` spec splits its H·hd columns.
- Training on (data 2, model 2) and (data 1, model 2), for ``xlstm-smoke``
  (its MLP of 85 whole) and ``WIDE`` (every block split), from the
  reference's parameters: each rank's loss (averaged over ``data``) within
  1e-3 (relative) of ``jax.value_and_grad`` of the reference's jitted loss
  on a (data 2, model 2) CPU mesh, and every leaf's gradient (the step's
  mean over ``data`` and agreement over ``model``, gathered) within
  ``test_torch_split_families.py``'s bounds: 4e-2 in L2, 6e-2 of the leaf's
  largest |g| (both sides multiply in bfloat16).
- Serving on (data 1, model 2) for both configs, and on (data 1, model 4)
  for ``xlstm-smoke`` (its mLSTM whole, its sLSTM split four ways), from
  seed 0: the greedy tokens of a prefill and four decode steps equal the
  one-rank port's, each step's logits within ``test_torch_serve_sharded.py``'s
  ATOL/RTOL; the state between steps is the rank's heads (``C``, ``n``) and
  channels (``c``, ``n``, ``h``), and a split block's decode sends no
  ``gather_cache@model`` (the whole mLSTM's state on model 4 is gathered).
- Bytes: each rank's ``SENT`` by ``op@axis`` equals ``analysis.roofline``'s
  count for ``WIDE``'s train step, prefill and decode step on (data 2,
  model 2), and for the (data 1, model 4) serve.
"""
import os

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import traceback
from collections import Counter

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import ShapeConfig, ShardingConfig, TrainConfig
from repro_torch.launch.mesh import AbstractMesh, spawn
from repro_torch.models import pshard

SSM = "xlstm-125m"
#: the smoke variant whose every block splits on model 2
WIDE_D = 96
B, S = 4, 16
GRAD_L2, GRAD_MAX = 4e-2, 6e-2
ATOL, RTOL = 6e-2, 2e-2
#: serving: rows, prompt, the cache's capacity, greedy steps
ROWS1, PROMPT1, CAP1, GEN = 2, 8, 16, 4
TCFG = TrainConfig(learning_rate=1e-3, warmup_steps=2, total_steps=50)
#: training cases: (config, (data, model))
TRAIN_CASES = {"smoke data2": ("smoke", (2, 2)), "smoke data1": ("smoke", (1, 2)),
               "wide data2": ("wide", (2, 2)), "wide data1": ("wide", (1, 2))}


def _cfg(kind: str, ref: bool = False):
    if ref:
        from repro.configs import get_smoke_config as ref_smoke

        cfg = ref_smoke(SSM)
    else:
        cfg = get_smoke_config(SSM)
    return cfg.replace(d_model=WIDE_D) if kind == "wide" else cfg


# ---------------------------------------------------------------------------
# The decisions
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax():
    return pytest.importorskip("jax")


def _expected_block(leaf: str, split, cfg):
    """(dim, slice) of the leaf ``leaf`` of a layer that the split reads as
    the rank's block, from the split's heads, channels and MLP width."""
    hd = cfg.head_dim_
    owner, _, kind = leaf.rpartition(".")
    if split.heads is not None and owner in ("wq", "wk", "wv", "wo_gate", "wo", "wi", "wf"):
        q = split.heads.q
        # a gate's columns are its heads, a product's hd columns a head; wo's rows
        dim = 0 if kind == "b" or owner == "wo" else 1
        return dim, q if owner in ("wi", "wf") else slice(q.start * hd, q.stop * hd)
    return None


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("kind", ["published", "smoke", "wide"])
def test_model_split_blocks_are_the_reference_param_spec_blocks(jax, kind, m):
    from repro.configs.base import ShardingConfig as RefSharding
    from repro.models import sharding as ref_sharding
    from repro_torch.models.sharding import P, local_slice

    cfg = get_config(SSM) if kind == "published" else _cfg(kind)
    sizes = {"data": 2, "model": m}
    D, H, hd, width = cfg.d_model, cfg.num_heads, cfg.head_dim_, pshard.slstm_width(cfg)
    shapes = {0: {"wq.w": (D, H * hd), "wk.w": (D, H * hd), "wv.w": (D, H * hd),
                  "wo_gate.w": (D, H * hd), "wi.w": (D, H), "wi.b": (H,), "wf.w": (D, H),
                  "wf.b": (H,), "wo.w": (H * hd, D), "ln.scale": (D,)},
              1: {**{f"{g}.{x}": ((D, D) if x == "w" else (D,))
                     for g in ("wz", "wi", "wf", "wo_gate") for x in ("w", "b")},
                  "r": (4, D), "ffn.gate.w": (D, width), "ffn.up.w": (D, width),
                  "ffn.down.w": (width, D), "ln.scale": (D,), "ln2.scale": (D,)}}
    for r in range(m):
        split = pshard.model_split(cfg, AbstractMesh(sizes, rank=r))
        assert split.seq is None and split.at(S).seq is None
        # each block by its own divisibility; an H that m does not divide keeps
        # the mLSTM whole even where H·hd divides
        assert (split.heads is not None) == (H % m == 0)
        assert (split.channels is not None) == (D % m == 0)
        assert (split.d_ff is not None) == (width % m == 0)
        for layer, leaves in shapes.items():
            assert split.is_slstm(layer) == (layer == 1)
            for leaf, shape in leaves.items():
                read = split.read_of(f"layers.{layer}.{leaf}")
                path = ("layers", str(layer)) + tuple(leaf.split("."))
                spec = P(*ref_sharding.param_spec(path, shape, RefSharding(), sizes))
                cut = local_slice(shape, spec, sizes, {"data": 0, "model": r})
                model_dims = [d for d, ax in enumerate(spec) if ax == "model"
                              or (isinstance(ax, tuple) and "model" in ax)]
                if leaf == "r":  # replicated; read as the rank's columns
                    assert spec == P(None, None)
                    if split.channels is None:
                        assert read is None
                    else:
                        assert read.how == "shared"
                        t = torch.arange(4 * D).reshape(4, D)
                        assert torch.equal(read.take(t), t[:, split.channels])
                    continue
                if read is None:
                    continue
                assert read is pshard.BLOCK, (layer, leaf)
                assert len(model_dims) == 1, (layer, leaf, spec)
                dim = model_dims[0]
                if layer == 0:
                    want = _expected_block(leaf, split, cfg)
                elif leaf.startswith("ffn."):
                    want = (0 if leaf == "ffn.down.w" else 1, split.d_ff)
                else:
                    want = (len(shape) - 1, split.channels)
                assert (dim, cut[dim]) == want, (layer, leaf)
        mlstm = {leaf for leaf in shapes[0] if split.read_of(f"layers.0.{leaf}") is not None}
        assert mlstm == (set(shapes[0]) - {"ln.scale"} if H % m == 0 else set())


def test_whole_mlstm_where_only_its_columns_divide(jax):
    """xlstm-smoke on model 4: the reference's ``wq`` spec cuts its 64
    columns into four blocks of 16, inside its heads of 32; the port keeps
    the mLSTM whole and splits the sLSTM's 64 channels."""
    from repro.configs.base import ShardingConfig as RefSharding
    from repro.models import sharding as ref_sharding

    cfg = get_smoke_config(SSM)
    sizes = {"data": 2, "model": 4}
    spec = ref_sharding.param_spec(("layers", "0", "wq", "w"), (64, 64), RefSharding(), sizes)
    assert tuple(spec)[1] == "model" and cfg.num_heads == 2
    split = pshard.model_split(cfg, AbstractMesh(sizes, rank=1))
    assert split.heads is None and split.channels == slice(16, 32)
    assert split.read_of("layers.0.wq.w") is None and split.read_of("layers.1.wz.w") is pshard.BLOCK


# ---------------------------------------------------------------------------
# The ranks
# ---------------------------------------------------------------------------


def _batch(cfg) -> dict:
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _train(case, params, mesh) -> dict:
    """One rank's loss and backward from the reference's parameters, then the
    step's mean over ``data`` and agreement over ``model``, each leaf
    gathered."""
    from repro_torch.models import registry
    from repro_torch.train import step as step_mod
    from repro_torch.train.trainer import ReconfigurableTrainer

    cfg = _cfg(TRAIN_CASES[case][0])
    tr = ReconfigurableTrainer(cfg, ShapeConfig("t", S, B, "train"), mesh, transport="xla")
    tr.init_state(params=params)
    layout = tr._layout
    loss = registry.loss(tr.model, step_mod.local_rows(_batch(cfg), mesh),
                         batch_split=mesh.shape["data"])
    loss.backward()
    grads = {n: p.grad for n, p in tr.model.named_parameters()}
    if mesh.shape["data"] > 1:
        grads = step_mod._mean_auto(grads, mesh, "data", layout)
    grads = step_mod._agree_over(grads, mesh, "model", layout)
    grads = {n: (layout.full(n, g) if layout is not None else g).numpy()
             for n, g in grads.items()}
    mean = float(step_mod._mean_over(loss.detach().reshape(1), mesh, ["data"]))
    return {"loss": mean, "grads": grads, "split": repr(tr.model._train_split(S))}


def _serve(kind: str, mesh) -> dict:
    """A prefill and ``GEN`` greedy decode steps on the mesh, from seed 0:
    tokens, logits, the state's shapes, each step's bytes."""
    from repro_torch import tree as T
    from repro_torch.comm import collectives
    from repro_torch.models import registry
    from repro_torch.serving import steps as S_

    cfg = _cfg(kind)
    model = registry.build(cfg, device="cpu", seed=0, mesh=mesh)
    steps = S_.ServeSteps(model, mesh, ShardingConfig(), ShapeConfig("serve", CAP1, ROWS1,
                                                                     "decode"))
    collectives.SENT.clear()
    cache, logits = steps.prefill({"tokens": _prompt(cfg)})
    sent = {"prefill": dict(collectives.SENT)}
    toks, out = [logits.argmax(-1, keepdim=True)], [logits.float().numpy()]
    collectives.SENT.clear()
    for _ in range(GEN):
        cache, logits = steps.decode(cache, toks[-1])
        toks.append(logits.argmax(-1, keepdim=True))
        out.append(logits.float().numpy())
    sent["decode"] = dict(collectives.SENT)
    return {"tokens": torch.cat(toks, 1).numpy(), "logits": out, "sent": sent,
            "split": repr(steps.split),
            "state": {tuple(p): tuple(x.shape) for p, x in T.flatten_with_paths(cache)
                      if torch.is_tensor(x)}}


def _prompt(cfg) -> torch.Tensor:
    rng = np.random.default_rng(3)
    return torch.from_numpy(rng.integers(0, cfg.vocab_size, (ROWS1, PROMPT1))).long()


def _bytes(mesh) -> dict:
    """``WIDE``'s train step, prefill and decode step on this mesh, by
    ``op@axis``."""
    from repro_torch.comm import collectives
    from repro_torch.data.synthetic import batches_for
    from repro_torch.serving import steps as S_
    from repro_torch.train.trainer import HostSpec, ReconfigurableTrainer

    cfg = _cfg("wide")
    shape = ShapeConfig("t", S, B, "train")
    tr = ReconfigurableTrainer(cfg, shape, mesh, tcfg=TCFG, transport="xla",
                               hosts=[HostSpec(0, ["xla"])])
    state = tr.init_state(0)
    collectives.SENT.clear()
    tr.step_fn(state, batches_for(cfg, shape)(0))
    out = {"train": dict(collectives.SENT)}
    model = S_.build_sharded(cfg, mesh, ShardingConfig(), seed=0)
    steps = S_.ServeSteps(model, mesh, ShardingConfig(), ShapeConfig("serve", 2 * S, B, "decode"))
    toks = torch.from_numpy(np.random.default_rng(5).integers(0, cfg.vocab_size, (B, S))).long()
    collectives.SENT.clear()
    cache, logits = steps.prefill({"tokens": toks})
    out["prefill"] = dict(collectives.SENT)
    collectives.SENT.clear()
    steps.decode(cache, logits.argmax(dim=-1, keepdim=True))
    out["decode"] = dict(collectives.SENT)
    return out


def _run(cases: dict) -> dict:
    import torch.distributed as dist

    out = {"rank": dist.get_rank()}
    for name, fn in cases.items():
        try:
            out[name] = fn()
        except Exception:
            out[name] = traceback.format_exc()
    return out


def _rank_two(params: dict) -> dict:
    """(data 1, model 2): training and serving (spawn target)."""
    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh((1, 2), ("data", "model"), device="cpu")
    cases = {f"train {c}": (lambda c=c: _train(c, params[TRAIN_CASES[c][0]], mesh))
             for c in TRAIN_CASES if TRAIN_CASES[c][1] == (1, 2)}
    cases.update({f"serve {k}": (lambda k=k: _serve(k, mesh)) for k in ("smoke", "wide")})
    return {"coords": dict(mesh.coords), **_run(cases)}


def _rank_four(params: dict) -> dict:
    """(data 2, model 2): training and bytes; (data 1, model 4): the smoke
    serve with its mLSTM whole (spawn target)."""
    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    cases = {f"train {c}": (lambda c=c: _train(c, params[TRAIN_CASES[c][0]], mesh))
             for c in TRAIN_CASES if TRAIN_CASES[c][1] == (2, 2)}
    cases["bytes"] = lambda: _bytes(mesh)
    out = {"coords": dict(mesh.coords), **_run(cases)}
    mesh4 = make_mesh((1, 4), ("data", "model"), device="cpu")
    out.update(_run({"serve smoke model4": lambda: _serve("smoke", mesh4)}))
    out["coords4"] = dict(mesh4.coords)
    return out


@pytest.fixture(scope="module")
def ref_params(jax):
    from repro.models.registry import build as ref_build

    return {k: jax.tree.map(np.asarray, ref_build(_cfg(k, ref=True)).init(jax.random.PRNGKey(0)))
            for k in ("smoke", "wide")}


def _spawned(target: str, world: int, params) -> list:
    out = spawn(f"test_torch_xlstm_split:{target}", world, backend="gloo", args=(params,),
                threads=1, timeout_s=600.0)
    for r in out:
        for key, val in r.items():
            assert not isinstance(val, str), f"rank {r['rank']}, {key}:\n{val}"
    return out


@pytest.fixture(scope="module")
def two_ranks(ref_params):
    return _spawned("_rank_two", 2, ref_params)


@pytest.fixture(scope="module")
def four_ranks(ref_params):
    return _spawned("_rank_four", 4, ref_params)


def _leaves(g) -> dict:
    import jax

    flat = jax.tree_util.tree_flatten_with_path(g)[0]
    return {".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): np.asarray(w)
            for path, w in flat}


@pytest.fixture(scope="module")
def reference(jax, ref_params):
    """By config, ``jax.value_and_grad`` of the reference's jitted loss on a
    (data 2, model 2) CPU mesh, its parameters laid out by its
    ``param_specs``."""
    import jax.numpy as jnp
    from jax.sharding import NamedSharding

    from repro import compat
    from repro.configs.base import ShardingConfig as RefSharding
    from repro.launch.mesh import make_test_mesh
    from repro.models.registry import build as ref_build

    mesh = make_test_mesh((2, 2), ("data", "model"))
    out = {}
    for kind in ("smoke", "wide"):
        model = ref_build(_cfg(kind, ref=True), mesh=mesh)
        specs = model.param_specs(RefSharding())
        batch = {k: jnp.asarray(v) for k, v in _batch(_cfg(kind)).items()}
        with (jax.set_mesh(mesh) if hasattr(jax, "set_mesh") else compat.use_mesh(mesh)):
            p = jax.tree.map(lambda x, s: jax.device_put(x, NamedSharding(mesh, s)),
                             ref_params[kind], specs)
            loss, g = jax.jit(jax.value_and_grad(model.loss))(p, batch)
        out[kind] = (float(loss), _leaves(g))
    return out


def _one_rank(kind: str) -> tuple:
    from repro_torch.models import registry
    from repro_torch.serving import steps as S_

    cfg = _cfg(kind)
    model = registry.build(cfg, device="cpu", seed=0)
    cache, logits = model.prefill(_prompt(cfg))
    cache = S_.fit_cache(cache, registry.cache_shapes(cfg, ShapeConfig("s", CAP1, ROWS1,
                                                                       "decode")))
    toks, out = [logits.argmax(-1, keepdim=True)], [logits.float().numpy()]
    for _ in range(GEN):
        cache, logits = model.decode_step(cache, toks[-1])
        toks.append(logits.argmax(-1, keepdim=True))
        out.append(logits.float().numpy())
    return torch.cat(toks, 1).numpy(), out


# ---------------------------------------------------------------------------
# Tests
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", list(TRAIN_CASES))
def test_loss_and_grads_match_reference_on_the_mesh(two_ranks, four_ranks, reference, case):
    kind, (n_data, _) = TRAIN_CASES[case]
    want_loss, want = reference[kind]
    ranks = four_ranks if n_data == 2 else two_ranks
    for r in ranks:
        rec = r[f"train {case}"]
        assert "channels=slice(" in rec["split"] and rec["split"].startswith("Split(heads=Heads")
        assert ("d_ff=None" in rec["split"]) == (kind == "smoke")  # 85 does not split
        assert abs(rec["loss"] - want_loss) <= 1e-3 * abs(want_loss), (r["coords"], rec["loss"])
        got = rec["grads"]  # xLSTM's layers are a list: the reference's names
        assert sorted(got) == sorted(want)
        for path, w in want.items():
            g = got[path]
            assert g.shape == w.shape, path
            assert np.linalg.norm(g - w) <= GRAD_L2 * np.linalg.norm(w), (path, r["coords"])
            assert np.abs(g - w).max() <= GRAD_MAX * np.abs(w).max(), (path, r["coords"])


@pytest.mark.parametrize("kind", ["smoke", "wide"])
def test_split_serve_greedy_tokens_equal_one_rank(two_ranks, kind):
    cfg = _cfg(kind)
    want_toks, want = _one_rank(kind)
    H, hd, D = cfg.num_heads, cfg.head_dim_, cfg.d_model
    for r in two_ranks:
        rec = r[f"serve {kind}"]
        np.testing.assert_array_equal(rec["tokens"], want_toks)
        for got, w in zip(rec["logits"], want):
            np.testing.assert_allclose(got, w, atol=ATOL, rtol=RTOL)
        # the state between steps: the rank's heads and channels
        assert rec["state"][("layers", 0, "C")] == (ROWS1, H // 2, hd, hd)
        assert rec["state"][("layers", 0, "n")] == (ROWS1, H // 2, hd)
        for leaf in ("c", "n", "h"):
            assert rec["state"][("layers", 1, leaf)] == (ROWS1, D // 2)
        decode = rec["sent"]["decode"]
        assert "gather_cache@model" not in decode
        assert decode["sum_partials@model"] > 0 and decode["gather_channels@model"] > 0


def test_serve_on_model4_keeps_the_mlstm_whole(four_ranks):
    """(data 1, model 4): 2 heads do not split four ways, so the mLSTM is
    whole and its state, which the reference's spec cuts on hd, is gathered
    a step; the sLSTM runs 16 of its 64 channels."""
    cfg = _cfg("smoke")
    want_toks, want = _one_rank("smoke")
    hd = cfg.head_dim_
    for r in four_ranks:
        rec = r["serve smoke model4"]
        assert rec["split"].startswith("Split(heads=None") and "channels=slice(" in rec["split"]
        np.testing.assert_array_equal(rec["tokens"], want_toks)
        for got, w in zip(rec["logits"], want):
            np.testing.assert_allclose(got, w, atol=ATOL, rtol=RTOL)
        assert rec["state"][("layers", 0, "C")] == (ROWS1, cfg.num_heads, hd // 4, hd)
        assert rec["state"][("layers", 1, "c")] == (ROWS1, cfg.d_model // 4)
        assert rec["sent"]["decode"]["gather_cache@model"] > 0
        assert "sum_partials@model" not in rec["sent"]["decode"]


def _predicted(mesh_sizes: dict, rank: int, shapes: dict) -> dict:
    from repro_torch.analysis import roofline

    mesh = AbstractMesh(mesh_sizes, rank=rank)
    return {phase: roofline.step_collectives(cfg, shape, mesh, tcfg=TCFG)
            for phase, (cfg, shape) in shapes.items()}


def test_sent_equals_the_roofline_count(four_ranks):
    cfg, smoke = _cfg("wide"), _cfg("smoke")
    for r in four_ranks:
        want = _predicted({"data": 2, "model": 2}, r["rank"], {
            "train": (cfg, ShapeConfig("t", S, B, "train")),
            "prefill": (cfg, ShapeConfig("p", S, B, "prefill")),
            "decode": (cfg, ShapeConfig("d", 2 * S, B, "decode"))})
        for phase, sent in r["bytes"].items():
            assert Counter(sent) == want[phase], (r["rank"], phase)
        train = r["bytes"]["train"]
        # the heads' and the MLP's "f" backward, no gather of a split block
        assert train["grad_all_reduce@model"] > 0 and "gather_param@model" not in train
        four = _predicted({"data": 1, "model": 4}, r["coords4"]["model"], {
            "prefill": (smoke, ShapeConfig("p", PROMPT1, ROWS1, "prefill")),
            "decode": (smoke, ShapeConfig("d", CAP1, ROWS1, "decode"))})
        sent = r["serve smoke model4"]["sent"]
        assert Counter(sent["prefill"]) == four["prefill"]
        assert Counter(sent["decode"]) == Counter(
            {k: v * GEN for k, v in four["decode"].items()})
