"""The compute split over ``model`` of the moe, audio and ssm families
(``repro_torch.models.pshard``): the decisions against the reference's
rules, and training on gloo ranks against ``jax.grad`` of the reference.

- ``model_split`` decides per family as the reference pins, its specs
  captured from ``with_sharding_constraint`` on a fake mesh (as
  ``test_torch_seqpar.py`` does) and from its parameter specs, on ``model``
  2 and 4, for qwen3-moe, dbrx, seamless and xlstm at their published and
  smoke widths: moe splits the query heads where the reference's
  ``shard_heads`` does (the KV heads as their block where its k spec does),
  no d_ff (its experts are the dispatch's), the residual over S where
  ``shard_activations`` does, the vocabulary where the table's spec names
  ``model``; audio the same, with d_ff where ``shard_model_dim`` splits it
  and the encoder's residual over the source by the same rule; ssm the
  mLSTM's heads where the reference's ``shard_heads`` splits them, the
  sLSTM's channels where |model| divides D, its MLP where it divides the
  MLP's width, and the vocabulary (``shard_batch`` pins nothing on S).
- Training on (data 2, model 2), from the reference's parameters:
  ``qwen3-moe-smoke`` under ``alltoall``, ``allgather`` and ``grouped``,
  ``seamless-smoke`` on 16 positions (a source of 4, split) and on 12 (a
  source of 3, which |model| 2 does not divide: the encoder's residual
  stays whole while the decoder's is split), and ``xlstm-smoke``. Each
  rank's loss (averaged over ``data``) and every leaf's gradient (the
  step's mean over ``data`` and agreement over ``model``, gathered) against
  ``jax.grad`` of the reference's loss on a four-device CPU mesh: the loss
  within 1e-3 (relative), each leaf within ``test_torch_train_families.py``'s
  bounds (4e-2 in L2, 6e-2 of its largest |g|; both sides multiply in
  bfloat16). moe is held to the reference run op by op (layers unrolled, no
  remat, not jitted: ``test_torch_train_families.py``'s note on a near-tied
  expert). The checkpointed layer inputs hold S/|model| positions (moe; the
  audio decoder, and its encoder where |model| divides the source), and the
  table, the head, the attention weights and (under a mesh dispatch) the
  expert banks are gathered over nothing of ``model``.
"""
import os

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import traceback

import numpy as np
import pytest
import torch

from repro_torch.comm.moe_dispatch import configure
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch.mesh import AbstractMesh, spawn
from repro_torch.models import pshard

MOE, DBRX, AUDIO, SSM = ("qwen3-moe-235b-a22b", "dbrx-132b", "seamless-m4t-medium",
                         "xlstm-125m")
DISPATCHES = ("alltoall", "allgather", "grouped")
B = 4
#: the positions of each training case; seamless's source is S/4 of them
CASES = {f"moe {impl}": (MOE, impl, 16) for impl in DISPATCHES}
CASES.update({"audio 16": (AUDIO, None, 16), "audio 12": (AUDIO, None, 12),
              "ssm": (SSM, None, 16)})
#: a leaf's gradient against the reference's: relative L2, and the largest
#: difference relative to the leaf's largest |g|
GRAD_L2, GRAD_MAX = 4e-2, 6e-2


# ---------------------------------------------------------------------------
# The decisions
# ---------------------------------------------------------------------------


def _ref_rules(monkeypatch, jax, cfg, m: int, lengths) -> dict:
    """What the reference pins on (data 2, model m): the query and KV heads,
    an MLP hidden (B, S, d_ff), the residual of each of ``lengths`` (by
    ``shard_activations``, or ``shard_batch`` for xLSTM's), and the
    embedding table's vocabulary dim (its parameter spec)."""
    from types import SimpleNamespace

    from repro.configs.base import ShardingConfig as RefSharding
    from repro.models import pshard as ref_pshard
    from repro.models import sharding as ref_sharding

    mesh = SimpleNamespace(axis_names=("data", "model"), shape={"data": 2, "model": m})
    monkeypatch.setattr(ref_pshard.compat, "current_mesh", lambda: mesh)
    monkeypatch.setattr(ref_pshard.compat, "axis_is_auto", lambda mesh, a: True)
    monkeypatch.setattr(ref_pshard.compat, "axis_size", lambda mesh, a: mesh.shape[a])
    monkeypatch.setattr(jax.lax, "with_sharding_constraint", lambda x, spec: tuple(spec))
    shape = lambda *s: jax.ShapeDtypeStruct(s, jax.numpy.bfloat16)  # noqa: E731
    pinned = lambda spec, dim: isinstance(spec, tuple) and spec[dim] == "model"  # noqa: E731
    hd = cfg.head_dim_
    residual = (ref_pshard.shard_batch if cfg.family == "ssm"
                else ref_pshard.shard_activations)
    table = ref_sharding.param_spec(("embed", "table"), (cfg.vocab_padded, cfg.d_model),
                                    RefSharding(), {"data": 2, "model": m})
    return {"q": pinned(ref_pshard.shard_heads(shape(8, 16, cfg.num_heads, hd)), 2),
            "k": pinned(ref_pshard.shard_heads(shape(8, 16, cfg.num_kv_heads, hd)), 2),
            "d_ff": pinned(ref_pshard.shard_model_dim(shape(8, 16, max(cfg.d_ff, 1)), 2), 2),
            "seq": {S: pinned(residual(shape(8, S, cfg.d_model)), 1) for S in lengths},
            "vocab": tuple(table)[0] == "model"}


LENGTHS = (1, 3, 12, 16, 2048)


@pytest.fixture(scope="module")
def jax():
    return pytest.importorskip("jax")


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", [MOE, DBRX, AUDIO, SSM])
def test_model_split_decides_by_the_reference_rules(jax, monkeypatch, arch, smoke, m):
    cfg = (get_smoke_config if smoke else get_config)(arch)
    src = {S: max(1, S // 4) for S in LENGTHS}  # the encoder-decoder's source
    want = _ref_rules(monkeypatch, jax, cfg, m, set(LENGTHS) | set(src.values()))
    for r in range(m):
        mesh = AbstractMesh({"data": 2, "model": m}, rank=r)
        split = pshard.model_split(cfg, mesh)
        assert split is not None and cfg.family in pshard.SPLIT_FAMILIES
        assert (split.vocab is not None) == want["vocab"]
        if split.vocab is not None:
            per = cfg.vocab_padded // m
            assert split.vocab == slice(r * per, (r + 1) * per)
        if cfg.family == "ssm":  # the mLSTM's heads, the sLSTM's channels and MLP
            assert (split.heads is not None) == want["q"]
            assert (split.channels is not None) == (cfg.d_model % m == 0)
            assert (split.d_ff is not None) == (pshard.slstm_width(cfg) % m == 0)
        else:
            assert (split.heads is not None) == want["q"]
            assert (split.heads is not None and split.heads.kv_block) == want["k"]
            assert (split.d_ff is not None) == (want["d_ff"] and cfg.family == "audio")
        assert split.d_in is None and not split.experts
        for S in LENGTHS:
            at = split.at(S, src[S] if cfg.family == "audio" else None)
            assert (at.seq is not None) == want["seq"][S], S
            if at.seq is not None:
                assert at.seq == slice(r * S // m, (r + 1) * S // m)
            if cfg.family == "audio":  # the encoder's residual over the source
                assert (at.src.seq is not None) == want["seq"][src[S]], S
        assert split.at(1).seq is None  # decode is never split


def test_the_split_reads_the_families_leaves():
    """The leaves the split reads otherwise than whole, by their names in the
    new families: the encoder-decoder's three attentions and its norm
    ``lnx``, by stack; ``src_proj`` and ``enc_norm`` by the encoder's split;
    the moe banks as the rank's experts only under ``with_experts``, else
    (on the rows gathered over S) as shared parts, with the router."""
    mesh = AbstractMesh({"data": 2, "model": 2})
    audio = pshard.model_split(get_smoke_config(AUDIO), mesh).at(16, 3)
    assert audio.seq is not None and audio.src.seq is None
    for stack in ("encoder.0.attn", "decoder.1.self_attn", "decoder.1.cross_attn"):
        for leaf in ("wq.w", "wk.w", "wv.w", "wo.w"):
            assert audio.read_of(f"{stack}.{leaf}") is pshard.BLOCK
    assert audio.read_of("decoder.0.lnx.scale") is pshard.SHARED
    assert audio.read_of("encoder.0.ln1.scale") is None  # the source stays whole
    assert audio.read_of("decoder.0.mlp.down.w") is pshard.BLOCK
    assert audio.read_of("src_proj.w") is None and audio.read_of("enc_norm.scale") is None
    assert audio.read_of("final_norm.scale") is pshard.SHARED
    both = pshard.model_split(get_smoke_config(AUDIO), mesh).at(16, 4)
    assert both.read_of("src_proj.w") is pshard.SHARED
    assert both.read_of("enc_norm.scale") is pshard.SHARED
    assert both.read_of("encoder.1.ln2.scale") is pshard.SHARED
    moe = pshard.model_split(get_smoke_config(MOE), mesh).at(16)
    for leaf in ("gate", "up", "down", "router.w"):
        assert moe.read_of(f"layers.0.moe.{leaf}") is pshard.SHARED
    experts = moe.with_experts()
    for leaf in ("gate", "up", "down"):
        assert experts.read_of(f"layers.0.moe.{leaf}") is pshard.BLOCK
    # the router enters the mesh dispatch through its own sum over model
    assert experts.read_of("layers.0.moe.router.w") is None
    ssm = pshard.model_split(get_smoke_config(SSM), mesh).at(16)
    assert ssm.seq is None
    # by layer kind: the mLSTM's wi (D, H) by heads, the sLSTM's (D, D) by
    # channels; the sLSTM's r its columns; its MLP (width 85) whole
    assert ssm.read_of("layers.0.wi.w") is pshard.BLOCK
    assert ssm.read_of("layers.1.wi.w") is pshard.BLOCK
    assert ssm.read_of("layers.1.r").how == "shared"
    assert ssm.read_of("layers.1.ffn.up.w") is None
    assert ssm.read_of("layers.0.ln.scale") is None
    assert ssm.read_of("embed.table") is pshard.BLOCK


# ---------------------------------------------------------------------------
# Training on the ranks
# ---------------------------------------------------------------------------


def _cfg(case):
    arch, impl, _ = CASES[case]
    cfg = get_smoke_config(arch)
    return configure(cfg, impl) if impl else cfg


def _batch(case) -> dict:
    from repro_torch.data.synthetic import frontend_stub

    cfg, S = _cfg(case), CASES[case][2]
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    batch.update(frontend_stub(cfg, ShapeConfig("t", S, B, "train"), 0))
    return batch


def _train(case, params, mesh) -> dict:
    """One rank's loss and backward from the reference's parameters, then the
    step's mean over ``data`` and agreement over ``model``, each leaf
    gathered; the checkpointed layer inputs' shapes; what each leaf's read
    gathered over ``model``."""
    from repro_torch.comm import collectives
    from repro_torch.models import registry, sharding, stacking
    from repro_torch.train import step as step_mod
    from repro_torch.train.trainer import ReconfigurableTrainer

    cfg, S = _cfg(case), CASES[case][2]
    tr = ReconfigurableTrainer(cfg, ShapeConfig("t", S, B, "train"), mesh, transport="xla")
    tr.init_state(params=params)
    layout = tr._layout
    local = step_mod.local_rows(_batch(case), mesh)
    saved, gathered = [], {}
    remat, read = stacking.remat, sharding.Layout.read

    def spy_remat(fn, policy):
        inner = remat(fn, policy)

        def run(first, g, x):
            saved.append(tuple((x[0] if isinstance(x, tuple) else x).shape))
            return inner(first, g, x)
        return run

    def spy_read(self, name, shard, rd=None):
        before = collectives.SENT.get("gather_param@model", 0)
        t = read(self, name, shard, rd)
        sent = collectives.SENT.get("gather_param@model", 0) - before
        gathered[name] = gathered.get(name, 0) + sent
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
    return {"loss": mean, "grads": grads, "saved": saved, "gathered": gathered,
            "stacks": tr.model.stacks()}


def _rank(params: dict) -> dict:
    """Every training case on this rank of four (spawn target): its record,
    or the traceback."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    out = {"rank": dist.get_rank(), "coords": dict(mesh.coords)}
    for case in CASES:
        try:
            out[case] = _train(case, params[CASES[case][0]], mesh)
        except Exception:
            out[case] = traceback.format_exc()
    return out


@pytest.fixture(scope="module")
def ref_params(jax):
    from repro.configs import get_smoke_config as ref_config
    from repro.models.registry import build as ref_build

    return {a: jax.tree.map(np.asarray, ref_build(ref_config(a)).init(jax.random.PRNGKey(0)))
            for a in (MOE, AUDIO, SSM)}


@pytest.fixture(scope="module")
def ranks(ref_params):
    out = spawn("test_torch_split_families:_rank", 4, backend="gloo", args=(ref_params,),
                threads=1, timeout_s=600.0)
    for r in out:
        for key, val in r.items():
            assert not isinstance(val, str), f"rank {r['rank']}, {key}:\n{val}"
    return out


def _leaves(g) -> dict:
    import jax

    flat = jax.tree_util.tree_flatten_with_path(g)[0]
    return {".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): np.asarray(w)
            for path, w in flat}


@pytest.fixture(scope="module")
def reference(jax, ref_params):
    """By case, ``jax.value_and_grad`` of the reference's loss on a (data 2,
    model 2) CPU mesh: moe op by op (its mesh dispatches' ``shard_map`` on
    the mesh), audio and ssm jitted with their parameters laid out by their
    ``param_specs``."""
    import dataclasses

    import jax.numpy as jnp
    from jax.sharding import NamedSharding

    from repro import compat
    from repro.configs import get_smoke_config as ref_config
    from repro.configs.base import ShardingConfig as RefSharding
    from repro.launch.mesh import make_test_mesh
    from repro.models import moe as rmoe
    from repro.models.registry import build as ref_build

    mesh = make_test_mesh((2, 2), ("data", "model"))
    out = {}
    for case, (arch, impl, _S) in CASES.items():
        batch = {k: jnp.asarray(v) for k, v in _batch(case).items()}
        if impl is not None:
            cfg = ref_config(arch).replace(scan_layers=False, remat="none")
            cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, dispatch=impl))
            p = jax.tree.map(jnp.asarray, ref_params[arch])
            loss, g = jax.value_and_grad(
                lambda p_, b_, cfg=cfg: rmoe.loss_fn(p_, b_, cfg, mesh=mesh))(p, batch)
        else:
            model = ref_build(ref_config(arch), mesh=mesh)
            specs = model.param_specs(RefSharding())
            with (jax.set_mesh(mesh) if hasattr(jax, "set_mesh") else compat.use_mesh(mesh)):
                p = jax.tree.map(lambda x, s: jax.device_put(x, NamedSharding(mesh, s)),
                                 ref_params[arch], specs)
                loss, g = jax.jit(jax.value_and_grad(model.loss))(p, batch)
        out[case] = (float(loss), _leaves(g))
    return out


def _tree(grads: dict, stacks: dict) -> dict:
    from repro_torch import tree as T
    from repro_torch.models.stacking import stack_layers

    tree = stack_layers({n: torch.from_numpy(g) for n, g in grads.items()}, stacks)
    return {".".join(map(str, path)): g.numpy() for path, g in T.flatten_with_paths(tree)}


@pytest.mark.parametrize("case", list(CASES))
def test_loss_and_grads_match_reference_on_the_mesh(ranks, reference, case):
    want_loss, want = reference[case]
    for r in ranks:
        rec = r[case]
        assert abs(rec["loss"] - want_loss) <= 1e-3 * abs(want_loss), (r["coords"], rec["loss"])
        got = _tree(rec["grads"], rec["stacks"])
        assert sorted(got) == sorted(want)
        for path, w in want.items():
            g = got[path]
            assert g.shape == w.shape, path
            assert np.linalg.norm(g - w) <= GRAD_L2 * np.linalg.norm(w), (path, r["coords"])
            assert np.abs(g - w).max() <= GRAD_MAX * np.abs(w).max(), (path, r["coords"])


@pytest.mark.parametrize("case", ["moe alltoall", "moe grouped", "audio 16", "audio 12"])
def test_checkpointed_layer_inputs_hold_the_ranks_positions(ranks, case):
    cfg, S = _cfg(case), CASES[case][2]
    D = cfg.d_model
    want = {(B // 2, S // 2, D)}
    if cfg.family == "audio":  # the encoder's: split where |model| divides the source
        S_src = S // cfg.encdec.src_ratio
        want.add((B // 2, S_src // 2 if S_src % 2 == 0 else S_src, D))
    for r in ranks:
        assert set(r[case]["saved"]) == want, r[case]["saved"]


@pytest.mark.parametrize("case", list(CASES))
def test_split_reads_gather_nothing_over_model(ranks, case):
    """No ``gather_param@model`` of the table, the head, an attention weight
    (moe, audio: every head splits on |model| 2), or an expert bank under a
    mesh dispatch."""
    cfg = _cfg(case)
    for r in ranks:
        gathered = r[case]["gathered"]
        assert gathered["embed.table"] == 0 and gathered.get("lm_head.w", 0) == 0
        for name, nbytes in gathered.items():
            leaf = name.split(".", 2)[-1]
            if cfg.family != "ssm" and leaf.split(".")[0] in ("attn", "self_attn",
                                                               "cross_attn"):
                assert nbytes == 0, name
            if CASES[case][1] in ("alltoall", "allgather") and leaf.split(".")[-1] in (
                    "gate", "up", "down") and ".moe." in name:
                assert nbytes == 0, name
