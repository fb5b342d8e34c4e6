"""Serving on a mesh (``repro_torch.serving.steps``) held to the one-rank
port and to the reference.

- ``cache_shardings``: equal, leaf for leaf, to the reference's
  ``serving.steps.cache_shardings`` specs for the cache of all ten
  published configs (``Model.cache_specs`` of a decode shape) on (data 2,
  model 2) and (pod 2, data 2, model 4), under ``auto``, ``heads`` and
  ``sequence``. The reference wraps each spec in a ``NamedSharding`` of a
  real mesh; here its ``NamedSharding`` is stood in by the bare spec, so the
  production-size mesh needs no devices.
- On the smoke configs of the dense, vlm, moe, hybrid and audio families
  (the reference's ``init(PRNGKey(0))`` parameters, converted), four gloo
  ranks on (data 2, model 2) serve a batch of 4 prompts of 12 tokens into
  a cache of 16 positions, in heads and in sequence mode, then three
  teacher-forced decode steps. Each rank's logits of its two rows, after
  prefill and after every step, against the port on one rank (the same
  cache capacity) and against the reference: its prefill, then its decode
  with the default (local) attention for heads mode (the reference's heads
  branch is layout-only) and with its own ``make_seq_sharded_decode`` on a
  four-device CPU mesh for sequence mode. Tolerance 6e-2 absolute plus
  2e-2 relative, as ``test_torch_serve.py`` holds the one-rank port to the
  reference (bfloat16 products, and the flash-decode combine's bfloat16
  P·V in sequence mode). The moe config's capacity factor is E/k, so that
  no token is dropped under either capacity (the mesh dispatch routes each
  rank's own tokens): the dispatches' drops are held to the reference's in
  ``test_torch_moe_sharded.py``.
- the two ranks along ``model`` return bit-equal logits;
- each rank's cache leaves shaped as the reference's ``NamedSharding``
  shards of its ``cache_shardings`` on a (data 2, model 2) CPU mesh;
- sequence mode raises on a capacity that ``model`` does not divide, heads
  mode on KV heads it does not divide.
"""
import os

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import dataclasses
import traceback
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch import tree as T
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import ShapeConfig, ShardingConfig
from repro_torch.launch.mesh import spawn
from repro_torch.models import registry
from repro_torch.serving import steps as S

ALL_ARCHS = ("qwen2-7b", "granite-34b", "llama3.2-1b", "mistral-nemo-12b", "hymba-1.5b",
             "qwen3-moe-235b-a22b", "dbrx-132b", "xlstm-125m", "seamless-m4t-medium",
             "phi-3-vision-4.2b")
MESHES = {"data2_model2": {"data": 2, "model": 2},
          "pod2_data2_model4": {"pod": 2, "data": 2, "model": 4}}
PARTITIONS = ("auto", "heads", "sequence")
#: the served families' smoke configs
SERVED = ("llama3.2-1b", "phi-3-vision-4.2b", "qwen3-moe-235b-a22b", "hymba-1.5b",
          "seamless-m4t-medium")
MODES = ("heads", "sequence")
B, PROMPT, CAP, STEPS = 4, 12, 16, 3
ATOL, RTOL = 6e-2, 2e-2


def port_cfg(arch):
    cfg = get_smoke_config(arch)
    if cfg.moe is not None:  # a capacity that drops nothing
        m = cfg.moe
        cfg = cfg.replace(moe=dataclasses.replace(m, capacity_factor=m.num_experts / m.top_k))
    return cfg


def ref_cfg(arch):
    from repro.configs import get_smoke_config as ref_smoke

    cfg = ref_smoke(arch)
    if cfg.moe is not None:
        m = cfg.moe
        cfg = cfg.replace(moe=dataclasses.replace(m, capacity_factor=m.num_experts / m.top_k))
    return cfg


def batch_np(cfg) -> dict:
    """The prompt batch and the teacher-forced decode tokens, from a seed."""
    rng = np.random.default_rng(11)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, PROMPT)).astype(np.int32),
           "next": rng.integers(0, cfg.vocab_size, (B, STEPS)).astype(np.int32)}
    if cfg.family == "vlm":
        f = cfg.frontend
        out["patches"] = rng.standard_normal((B, f.num_positions, f.embed_dim))
    if cfg.family == "audio":
        out["frames"] = rng.standard_normal((B, PROMPT // cfg.encdec.src_ratio,
                                             cfg.frontend.embed_dim))
    return {k: (v.astype(np.float32) if v.dtype == np.float64 else v) for k, v in out.items()}


def torch_batch(b: dict) -> dict:
    out = {"tokens": torch.from_numpy(b["tokens"]).long()}
    for k in ("patches", "frames"):
        if k in b:
            out[k] = torch.from_numpy(b[k]).to(torch.bfloat16)
    return out


SHAPE = ShapeConfig("t", CAP, B, "decode")

# ---------------------------------------------------------------------------
# The ranks
# ---------------------------------------------------------------------------


def _serve_case(arch, mode, params, mesh) -> dict:
    from repro_torch.models.convert import params_from_reference

    cfg = port_cfg(arch)
    b = batch_np(cfg)
    model = params_from_reference(params, cfg, device="cpu")
    steps = S.ServeSteps(model, mesh, ShardingConfig(kv_partition=mode), SHAPE)
    cache, logits = steps.prefill(torch_batch(b))
    rec = {"mode": steps.mode, "kv": steps.kv.name, "prefill": logits.float().numpy(),
           "shapes": {p: tuple(x.shape) for p, x in T.flatten_with_paths(cache)
                      if torch.is_tensor(x)}}
    for t in range(STEPS):
        tok = steps.rows(torch.from_numpy(b["next"][:, t:t + 1]).long())
        cache, logits = steps.decode(cache, tok)
        rec[f"decode{t}"] = logits.float().numpy()
    rec["len"] = cache["len"]
    return rec


def _rank_serve(params: dict) -> dict:
    """Every (arch, mode) on this rank (spawn target): its record or the
    traceback."""
    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    out = {"coords": dict(mesh.coords)}
    for arch in SERVED:
        for mode in MODES:
            try:
                out[(arch, mode)] = _serve_case(arch, mode, params[arch], mesh)
            except Exception:
                out[(arch, mode)] = traceback.format_exc()
    return out


# ---------------------------------------------------------------------------
# Fixtures
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax():
    return pytest.importorskip("jax")


@pytest.fixture(scope="module")
def ref_params(jax):
    from repro.models.registry import build as ref_build

    return {arch: jax.tree.map(np.asarray, ref_build(ref_cfg(arch)).init(jax.random.PRNGKey(0)))
            for arch in SERVED}


@pytest.fixture(scope="module")
def four_ranks(ref_params):
    ranks = spawn("test_torch_serve_sharded:_rank_serve", 4, backend="gloo",
                  args=(ref_params,), threads=1, timeout_s=400.0)
    for r, out in enumerate(ranks):
        for key, val in out.items():
            assert not isinstance(val, str), f"rank {r}, {key}:\n{val}"
    return ranks


@pytest.fixture(scope="module")
def ref_mesh(jax):
    from repro.launch.mesh import make_test_mesh

    return make_test_mesh((2, 2), ("data", "model"))


def _pad_to(cache, like, jnp):
    """The reference's prefill cache zero-padded to ``like``'s shapes."""
    import jax as _jax

    def pad(x, ref):
        if not hasattr(x, "shape") or x.shape == ref.shape:
            return x
        return jnp.pad(x, [(0, w - s) for s, w in zip(x.shape, ref.shape)])

    return _jax.tree.map(pad, cache, like)


@pytest.fixture(scope="module")
def reference(jax, ref_params, ref_mesh):
    """The reference's logits by (arch, mode): prefill, then each
    teacher-forced decode step, heads with the local decode attention,
    sequence with its flash-decode over the CPU mesh's ``model`` axis."""
    import jax.numpy as jnp
    from repro.comm.kvshard import make_seq_sharded_decode
    from repro.configs.base import ShapeConfig as RefShape
    from repro.models.registry import build as ref_build

    out = {}
    for arch in SERVED:
        cfg = ref_cfg(arch)
        b = batch_np(cfg)
        params = jax.tree.map(jnp.asarray, ref_params[arch])
        batch = {"tokens": jnp.asarray(b["tokens"])}
        for k in ("patches", "frames"):
            if k in b:
                batch[k] = jnp.asarray(b[k]).astype(jnp.bfloat16)
        model = ref_build(cfg)
        cache0, logits0 = jax.jit(model.prefill)(params, batch)
        like = model.cache_specs(RefShape("t", CAP, B, "decode"))
        for mode in MODES:
            fn = make_seq_sharded_decode(ref_mesh) if mode == "sequence" else None
            dec = jax.jit(ref_build(cfg, decode_attn_fn=fn).decode)
            cache = _pad_to(cache0, like, jnp)
            rec = {"prefill": np.asarray(logits0, np.float32)}
            for t in range(STEPS):
                cache, logits = dec(params, cache, {"tokens": jnp.asarray(b["next"][:, t:t + 1])})
                rec[f"decode{t}"] = np.asarray(logits, np.float32)
            out[(arch, mode)] = rec
    return out


@pytest.fixture(scope="module")
def one_rank(ref_params):
    """The port on one rank: prefill of the whole batch, its cache fitted to
    the same capacity, the same decode steps."""
    from repro_torch.models.convert import params_from_reference

    out = {}
    for arch in SERVED:
        cfg = port_cfg(arch)
        b = batch_np(cfg)
        model = params_from_reference(ref_params[arch], cfg, device="cpu")
        cache, logits = model.prefill(**torch_batch(b))
        cache = S.fit_cache(cache, registry.cache_shapes(cfg, SHAPE))
        rec = {"prefill": logits.float().numpy()}
        for t in range(STEPS):
            cache, logits = model.decode_step(cache, torch.from_numpy(b["next"][:, t:t + 1]).long())
            rec[f"decode{t}"] = logits.float().numpy()
        out[arch] = rec
    return out


def rows_of(rank_out) -> slice:
    d = rank_out["coords"]["data"]
    return slice(2 * d, 2 * d + 2)


KEYS = ["prefill"] + [f"decode{t}" for t in range(STEPS)]

# ---------------------------------------------------------------------------
# Tests
# ---------------------------------------------------------------------------


def _ref_cache_specs(monkeypatch, arch, mesh_shape, partition):
    from repro.configs import get_config as ref_config
    from repro.configs.base import ShapeConfig as RefShape
    from repro.configs.base import ShardingConfig as RefSharding
    from repro.models.registry import build as ref_build
    from repro.serving import steps as ref_steps

    monkeypatch.setattr(ref_steps, "NamedSharding", lambda mesh, spec: spec)
    mesh = SimpleNamespace(axis_names=tuple(mesh_shape), shape=dict(mesh_shape))
    specs = ref_build(ref_config(arch)).cache_specs(RefShape("d", 4096, 8, "decode"))
    return ref_steps.cache_shardings(specs, ref_config(arch), mesh,
                                     RefSharding(kv_partition=partition))


@pytest.mark.parametrize("partition", PARTITIONS)
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_cache_shardings_match_reference(jax, monkeypatch, arch, mesh, partition):
    want = _ref_cache_specs(monkeypatch, arch, MESHES[mesh], partition)
    want = jax.tree_util.tree_flatten_with_path(
        want, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    shapes = registry.cache_shapes(get_config(arch), ShapeConfig("d", 4096, 8, "decode"))
    port_mesh = SimpleNamespace(axis_names=tuple(MESHES[mesh]), shape=dict(MESHES[mesh]))
    got = T.flatten_with_paths(S.cache_shardings(shapes, get_config(arch), port_mesh,
                                                 ShardingConfig(kv_partition=partition)))
    assert len(got) == len(want)
    for (path, spec), (rpath, rspec) in zip(got, want):
        rkeys = tuple(str(getattr(k, "key", getattr(k, "idx", k))) for k in rpath)
        assert tuple(str(k) for k in path) == rkeys
        assert tuple(spec) == tuple(rspec), (path, spec, rspec)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", SERVED)
def test_sharded_logits_match_one_rank_and_reference(four_ranks, reference, one_rank,
                                                     arch, mode):
    for r in four_ranks:
        rec = r[(arch, mode)]
        assert rec["kv"] == {"heads": "KVHeadSharded", "sequence": "KVSeqSharded"}[mode]
        assert rec["len"] == PROMPT + STEPS
        rows = rows_of(r)
        for key in KEYS:
            got = rec[key]
            assert got.shape[0] == 2 and np.isfinite(got).all()
            np.testing.assert_allclose(got, one_rank[arch][key][rows], atol=ATOL, rtol=RTOL,
                                       err_msg=f"{key} vs the one-rank port")
            np.testing.assert_allclose(got, reference[(arch, mode)][key][rows], atol=ATOL,
                                       rtol=RTOL, err_msg=f"{key} vs the reference")


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", SERVED)
def test_model_group_agrees_bit_for_bit(four_ranks, arch, mode):
    for a in four_ranks:
        for b in four_ranks:
            if a["coords"]["data"] == b["coords"]["data"]:
                for key in KEYS:
                    np.testing.assert_array_equal(a[(arch, mode)][key], b[(arch, mode)][key])


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", SERVED)
def test_cache_leaves_are_the_spec_shards(jax, four_ranks, ref_mesh, arch, mode):
    """Every rank's leaves between steps have the shapes of the reference's
    ``NamedSharding`` shards of its cache shardings on a real (data 2,
    model 2) mesh."""
    from repro.configs.base import ShapeConfig as RefShape
    from repro.configs.base import ShardingConfig as RefSharding
    from repro.models.registry import build as ref_build
    from repro.serving.steps import cache_shardings as ref_cache_shardings

    cfg = ref_cfg(arch)
    specs = ref_build(cfg).cache_specs(RefShape("t", CAP, B, "decode"))
    shs = ref_cache_shardings(specs, cfg, ref_mesh, RefSharding(kv_partition=mode))
    flat = jax.tree_util.tree_flatten_with_path(specs)[0]
    want = {}
    for (path, leaf), sh in zip(flat, jax.tree.leaves(shs)):
        if len(leaf.shape):
            keys = tuple(getattr(k, "key", getattr(k, "idx", k)) for k in path)
            want[keys] = tuple(sh.shard_shape(leaf.shape))
    for r in four_ranks:
        got = r[(arch, mode)]["shapes"]
        assert set(got) == set(want)
        for path, shape in got.items():
            assert shape == want[path], path


def test_sequence_mode_needs_a_capacity_model_divides():
    """A capacity of 15 on a model axis of 2: the reference's cache_spec_for
    would replicate the sequence, so the steps raise rather than serve
    another layout; heads mode raises on 5 KV heads over 2."""
    mesh = SimpleNamespace(axis_names=("data", "model"), shape={"data": 1, "model": 2},
                           coords={"data": 0, "model": 0})
    model = registry.build(port_cfg("llama3.2-1b"), device="cpu", seed=0)
    with pytest.raises(ValueError, match="does not split over model"):
        S.ServeSteps(model, mesh, ShardingConfig(kv_partition="sequence"),
                     ShapeConfig("t", 15, 2, "decode"))
    hymba = get_config("hymba-1.5b")
    with pytest.raises(ValueError, match="5 KV heads do not split"):
        S.ServeSteps(SimpleNamespace(cfg=hymba), mesh, ShardingConfig(kv_partition="heads"),
                     ShapeConfig("t", 16, 2, "decode"))


def test_capacity_for_rounds_to_a_multiple_of_64():
    assert S.capacity_for(2048, 32) == 2112
    assert S.capacity_for(12, 4) == 64
    assert S.capacity_for(64, 0) == 64


@pytest.mark.parametrize("arch,kv,dispatch", [("llama3.2-1b", "heads", None),
                                              ("llama3.2-1b", "sequence", None),
                                              ("qwen3-moe-235b-a22b", "heads", "grouped")])
def test_launcher_world_serves_the_one_rank_tokens(arch, kv, dispatch):
    """``python -m repro_torch.launch.serve --world 4 --data 2 --model 2``:
    four spawned ranks generate, row for row, the one-rank launcher's
    greedy tokens from the same seed, and send what their chunnel sends:
    the heads branch of a model that splits its compute over ``model``
    (llama, and qwen3-moe since its family splits too) sums its row
    products (``sum_partials``) and all-gathers no attention output."""
    from repro_torch.launch import serve

    args = ["--arch", arch, "--smoke", "--device", "cpu", "--batch", "4", "--prompt-len", "24",
            "--gen", "4"]
    one = serve.main(args).tokens.numpy()
    ranks = serve.main(args + ["--world", "4", "--threads", "1", "--data", "2", "--model", "2",
                               "--kv-partition",
                               kv] + (["--moe-dispatch", dispatch] if dispatch else []))
    assert len(ranks) == 4
    for r in ranks:
        rows = rows_of(r)
        run, = r["runs"]
        np.testing.assert_array_equal(run["tokens"], one[rows])
        assert run["kv"] == {"heads": "KVHeadSharded", "sequence": "KVSeqSharded"}[kv]
        want = "all_gather@model" if kv == "heads" else "all_reduce_max@model"
        if kv == "heads":  # the split: wo's sum, no gather
            assert "all_gather@model" not in run["sent_decode"]
            want = "sum_partials@model"
        assert want in run["sent_decode"]


def _rank_serve_runs(spec: dict) -> dict:
    """``serve_rank`` with an observer that records its calls (spawn target)."""
    seen = []
    out = S.serve_rank(spec, observe=lambda run, phase: seen.append((run, phase)))
    out["observed"] = seen
    return out


def test_serve_rank_runs_and_check_step():
    """``serve_rank`` serves each of its runs on the one laid-out model: on
    (data 2, model 2), heads then sequence, each rank's greedy tokens equal
    the one-rank launcher's for its rows; the check step's logits, from a
    copy of the prefill's cache, are the one-rank decode step's on the same
    tokens (within ATOL/RTOL) and leave the greedy tokens as they were; the
    observer is called at the start and after every phase of each run."""
    from repro_torch.launch import serve

    cfg = get_smoke_config("llama3.2-1b")
    prompt, gen = 24, 4
    check = np.random.default_rng(5).integers(0, cfg.vocab_size, (B, 1)).astype(np.int64)
    args = ["--arch", "llama3.2-1b", "--smoke", "--device", "cpu", "--batch", str(B),
            "--prompt-len", str(prompt), "--gen", str(gen)]
    one_tokens = serve.main(args).tokens.numpy()
    model = registry.build(cfg, device="cpu", seed=serve.SEED)
    tokens, _ = serve.serve_batch(cfg, B, prompt, torch.device("cpu"))
    cache, _ = model.prefill(tokens)
    cache = S.fit_cache(cache, registry.cache_shapes(
        cfg, ShapeConfig("t", S.capacity_for(prompt, gen), B, "decode")))
    _, one_check = model.decode_step(cache, torch.from_numpy(check))
    spec = {"arch": "llama3.2-1b", "world": 4, "data": 2, "model": 2, "smoke": True,
            "batch": B, "prompt_len": prompt, "gen": gen, "device": "cpu",
            "attn_impl": "pallas", "runs": [("heads", None), ("sequence", None)],
            "check_tokens": check}
    ranks = spawn("test_torch_serve_sharded:_rank_serve_runs", 4, backend="gloo",
                  args=(spec,), threads=1, timeout_s=300.0)
    phases = ["start", "prefill", "check", "decode"]
    for r in ranks:
        rows = rows_of(r)
        assert [run["kv"] for run in r["runs"]] == ["KVHeadSharded", "KVSeqSharded"]
        assert r["observed"] == [(i, ph) for i in range(2) for ph in phases]
        for run in r["runs"]:
            np.testing.assert_array_equal(run["tokens"], one_tokens[rows])
            np.testing.assert_allclose(run["check_logits"], one_check.float().numpy()[rows],
                                       atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "hymba-1.5b", "seamless-m4t-medium"])
def test_plain_function_in_the_decode_slot(arch):
    """A plain ``attn_fn(q, k_cache, v_cache, kv_len, window)`` over a whole
    local cache, the reference's slot signature, fills the slot: the same
    logits as the default, and the slot is called once per layer that
    attends through it (every layer; hymba's global layers only)."""
    from repro_torch.models.attention import decode_attention_local

    cfg = port_cfg(arch)
    b = batch_np(cfg)
    model = registry.build(cfg, device="cpu", seed=0)
    cache, _ = model.prefill(**torch_batch(b))
    tok = torch.from_numpy(b["next"][:, :1]).long()
    calls = []

    def attn_fn(q, k, v, kv_len, window):
        calls.append(kv_len)
        return decode_attention_local(q, k, v, kv_len, window=window)

    _, want = model.decode_step(model.grow_cache(cache, 2), tok)
    _, got = model.decode_step(model.grow_cache(cache, 2), tok, attn_fn)
    assert torch.equal(got, want)
    n_slot = (len(cfg.global_layers) if cfg.family == "hybrid"
              else cfg.encdec.dec_layers if cfg.family == "audio" else cfg.num_layers)
    assert calls == [PROMPT + 1] * n_slot
