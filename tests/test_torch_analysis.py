"""The port's cost analysis (``repro_torch.analysis``) against the
reference's (``repro.analysis``).

- ``flops``: parameter counts, layerwise forward FLOPs and step costs equal
  the reference's for every arch x shape x production mesh (relative 1e-12);
  the reference's config-only tests of ``tests/test_flops_validation.py`` run
  on the port (``port_mirror``); and the port's form of its two HLO-count
  tests, with ``torch.utils.flop_counter.FlopCounterMode`` counting a
  2-layer llama's products on meta tensors: the forward within 15% of the
  analytic forward, forward plus backward within 25% of three times it.
- ``roofline``: the H100 tiers of the production meshes, the roofline's
  terms, and ``step_collectives`` held op by op (``op@axis``) to
  ``comm.collectives.SENT`` from four gloo ranks running the same steps:
  a sharded train step on (data 2, model 2) and a compressed one on (pod 2,
  model 2); a prefill and a decode step under heads and under sequence
  partition, and the MoE dispatches, on (data 2, model 2); a sharded moe
  train step with each dispatch (``alltoall``, ``allgather``, ``grouped``),
  its backward's collectives under their own names, on (data 2, model 2);
  and the compute split over ``model`` of the dense and hybrid families
  (``models.pshard``): llama's steps above, and hymba's train step and its
  heads and sequence serve steps, whose row products' sums
  (``sum_partials``), "f" conjugates' backward (``grad_all_reduce``) and
  shared parameter reads (``in_proj``, ``x_proj``) are counted.
"""
import math
from collections import Counter

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from port_mirror import mirror
from repro_torch.analysis import flops as F
from repro_torch.analysis import roofline
from repro_torch.comm.moe_dispatch import configure
from repro_torch.configs import ARCH_IDS, SHAPES, get_config, get_smoke_config
from repro_torch.configs.base import ShapeConfig, ShardingConfig, TrainConfig
from repro_torch.launch.mesh import HW, AbstractMesh, production_shape, spawn
from repro_torch.models import registry

MESHES = {"16x16": production_shape(False), "2x16x16": production_shape(True)}
CELLS = [(a, s, m) for a in ARCH_IDS for s in SHAPES for m in MESHES]


@pytest.fixture(scope="module")
def ref_flops():
    pytest.importorskip("jax")
    from repro.analysis import flops as ref_f
    from repro.configs import get_config as ref_config
    from repro.configs import get_shape as ref_shape

    return ref_f, ref_config, ref_shape


def _close(a, b):
    assert math.isclose(a, b, rel_tol=1e-12, abs_tol=0.0), (a, b)


@pytest.mark.parametrize("arch,shape,mesh", CELLS, ids=[f"{a}-{s}-{m}" for a, s, m in CELLS])
def test_analytic_numbers_equal_reference(ref_flops, arch, shape, mesh):
    ref_f, ref_config, ref_shape = ref_flops
    cfg, rcfg = get_config(arch), ref_config(arch)
    shp, rshp = SHAPES[shape], ref_shape(shape)
    _close(F.param_count(cfg), ref_f.param_count(rcfg))
    _close(F.active_param_count(cfg), ref_f.active_param_count(rcfg))
    for got, want in zip(F.fwd_flops_layerwise(cfg, shp, shp.kind),
                         ref_f.fwd_flops_layerwise(rcfg, rshp, rshp.kind)):
        _close(got, want)
    got, want = F.step_cost(cfg, shp, MESHES[mesh]), ref_f.step_cost(rcfg, rshp, MESHES[mesh])
    for key in ("flops", "bytes_hbm", "model_flops", "params"):
        _close(getattr(got, key), getattr(want, key))


# -- the reference's config-only tests, on the port ------------------------------

_MIRRORED = mirror("test_flops_validation.py", ["TestAnalyticFlops"], edits=[
    ("import jax\nimport jax.numpy as jnp\n", "from port_mirror import jax, jnp\n"),
    ("from repro import compat\n", "from port_mirror import compat\n"),
    ("from repro.models import build\n",
     "from repro.models.registry import build, param_shapes\nfrom repro import tree as T\n"),
    ("model = build(cfg)\n            tree = model.param_shapes()",
     'model = build(cfg, device="meta")\n            tree = param_shapes(model)'),
    ("jax.tree.leaves(tree)", "T.leaves(tree)"),
])["TestAnalyticFlops"]


class TestAnalyticFlops:
    """The reference's config-only ``TestAnalyticFlops`` cases on the port's
    configs (``test_param_count_matches_real_tree`` on the port's own
    parameter trees)."""

    test_param_counts_match_declared_sizes = _MIRRORED.test_param_counts_match_declared_sizes
    test_moe_active_params = _MIRRORED.test_moe_active_params
    test_decode_flops_scale_with_cache = _MIRRORED.test_decode_flops_scale_with_cache
    test_param_count_matches_real_tree = _MIRRORED.test_param_count_matches_real_tree


# -- FlopCounterMode against the analytic count ------------------------------------


def _probe():
    """The reference's HLO-count probe: llama3.2-1b at 2 layers, vocab 1024,
    dense attention, no remat, the loss unchunked; batch 2 x 256."""
    cfg = get_config("llama3.2-1b").replace(num_layers=2, remat="none", attn_impl="xla_dense",
                                            loss_chunk=None, vocab_size=1024)
    shape = ShapeConfig("probe", 256, 2, "train")
    model = registry.build(cfg, device="meta").release()
    batch = {k: torch.zeros(s, dtype=dt, device="meta")
             for k, (s, dt) in registry.batch_specs(cfg, shape).items()}
    layers_fwd, head_fwd = F.fwd_flops_layerwise(cfg, shape, "train")
    return model, batch, layers_fwd + head_fwd


def test_dense_fwd_counted_within_15_percent():
    model, batch, analytic = _probe()
    with FlopCounterMode(display=False) as fc:
        registry.loss(model, batch)
    ratio = fc.get_total_flops() / analytic
    assert 0.85 < ratio < 1.15, f"fwd ratio {ratio}"


def test_dense_train_counted_within_25_percent():
    model, batch, analytic = _probe()
    with FlopCounterMode(display=False) as fc:
        registry.loss(model, batch).backward()
    ratio = fc.get_total_flops() / (3.0 * analytic)
    assert 0.75 < ratio < 1.25, f"train ratio {ratio}"


# -- the H100 roofline -------------------------------------------------------------


def test_production_axes_cross_nodes():
    """8 GPUs a node: every axis of both production meshes crosses
    InfiniBand; a (data 2, model 4) mesh stays on one node's NVLink."""
    for shape in MESHES.values():
        assert {a: roofline.axis_tier(shape, a) for a in shape} == {a: "ib" for a in shape}
    small = {"data": 2, "model": 4}
    assert {a: roofline.axis_tier(small, a) for a in small} == {"data": "nvlink",
                                                                 "model": "nvlink"}
    assert roofline.axis_tier({"data": 4, "model": 4}, "data") == "ib"
    assert roofline.axis_tier({"data": 4, "model": 4}, "model") == "nvlink"


def test_roofline_terms_price_the_h100():
    cfg, shape = get_config("llama3.2-1b"), SHAPES["decode_32k"]
    mesh = MESHES["16x16"]
    sent = roofline.step_collectives(cfg, shape, AbstractMesh(mesh))
    rf = roofline.analyze(sent, cfg, shape, mesh)
    cost = F.step_cost(cfg, shape, mesh)
    assert rf.compute_s == cost.flops / 256 / HW["peak_flops_bf16"]
    assert rf.memory_s == cost.bytes_hbm / 256 / HW["hbm_bw"]
    assert rf.coll_bytes_per_dev == rf.dcn_bytes_per_dev == sum(sent.values()) > 0
    assert rf.collective_s == sum(sent.values()) / HW["ib_bw"]
    assert rf.dominant == max(("compute", "memory", "collective"),
                              key=lambda k: getattr(rf, f"{k}_s"))
    assert 0 < rf.mfu < 1


# -- step_collectives against SENT from a gloo run ----------------------------------

ARCH, MOE, HYBRID = "llama3.2-1b", "qwen3-moe-235b-a22b", "hymba-1.5b"
TRAIN = ShapeConfig("t", 64, 4, "train")
TCFG = TrainConfig(learning_rate=1e-3, warmup_steps=2, total_steps=50)
PROMPT, CAPACITY, ROWS = 24, 64, 4
#: name -> (mesh shape, axes, what runs)
RUNS = {
    "train data2 model2 xla": ((2, 2), ("data", "model"), ("train", ARCH, "xla")),
    "train pod2 model2 compressed": ((2, 2), ("pod", "model"),
                                     ("train", ARCH, "compressed_int8")),
    # the transports on a rank's own shard of the gradient (FSDP on data)
    "train pod2 model2 psum": ((2, 2), ("pod", "model"), ("train", ARCH, "psum")),
    "train pod2 data2 psum": ((2, 2), ("pod", "data"), ("train", ARCH, "psum")),
    "serve heads": ((2, 2), ("data", "model"), ("serve", ARCH, "heads")),
    "serve sequence": ((2, 2), ("data", "model"), ("serve", ARCH, "sequence")),
    "serve moe alltoall": ((2, 2), ("data", "model"), ("serve", MOE, "alltoall")),
    "serve moe allgather": ((2, 2), ("data", "model"), ("serve", MOE, "allgather")),
    "train moe alltoall": ((2, 2), ("data", "model"), ("train", MOE, "xla", "alltoall")),
    "train moe allgather": ((2, 2), ("data", "model"), ("train", MOE, "xla", "allgather")),
    "train moe grouped": ((2, 2), ("data", "model"), ("train", MOE, "xla", "grouped")),
    # the compute split over model of the hybrid family: heads, channels, d_ff
    "train hymba data2 model2 xla": ((2, 2), ("data", "model"), ("train", HYBRID, "xla")),
    "serve hymba heads": ((2, 2), ("data", "model"), ("serve", HYBRID, "heads")),
    "serve hymba sequence": ((2, 2), ("data", "model"), ("serve", HYBRID, "sequence")),
}


def _measured(mesh, what) -> dict:
    """SENT of each step of ``what`` on this rank, by phase."""
    from repro_torch.comm import collectives
    from repro_torch.data.synthetic import batches_for
    from repro_torch.serving import steps as S
    from repro_torch.train.trainer import HostSpec, ReconfigurableTrainer

    kind, arch, option, *dispatch = what
    cfg = get_smoke_config(arch)
    if dispatch:
        cfg = configure(cfg, dispatch[0])
    out = {}
    if kind == "train":
        tr = ReconfigurableTrainer(cfg, TRAIN, mesh, tcfg=TCFG, transport=option,
                                   hosts=[HostSpec(0, [option])])
        state = tr.init_state(0)
        collectives.SENT.clear()
        tr.step_fn(state, batches_for(cfg, TRAIN)(0))
        out["train"] = dict(collectives.SENT)
        return out
    if cfg.moe is not None:
        cfg = configure(cfg, option)
        sh = ShardingConfig()
    else:
        sh = ShardingConfig(kv_partition=option)
    model = S.build_sharded(cfg, mesh, sh, seed=0)
    steps = S.ServeSteps(model, mesh, sh, ShapeConfig("serve", CAPACITY, ROWS, "decode"))
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (ROWS, PROMPT))).long()
    collectives.SENT.clear()
    cache, logits = steps.prefill({"tokens": tokens})
    out["prefill"] = dict(collectives.SENT)
    collectives.SENT.clear()
    steps.decode(cache, logits.argmax(dim=-1, keepdim=True))
    out["decode"] = dict(collectives.SENT)
    return out


def _rank_collectives() -> dict:
    """Every run of ``RUNS`` on this rank (spawn target): its coordinates and
    SENT by phase, or the traceback."""
    import traceback

    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh

    out = {}
    for name, (shape, axes, what) in RUNS.items():
        try:
            mesh = make_mesh(shape, axes, device="cpu")
            out[name] = (dist.get_rank(), _measured(mesh, what))
        except Exception:
            out[name] = traceback.format_exc()
    return out


@pytest.fixture(scope="module")
def four_ranks():
    ranks = spawn("test_torch_analysis:_rank_collectives", 4, backend="gloo", threads=1,
                  timeout_s=300.0)
    for r, out in enumerate(ranks):
        for name, val in out.items():
            assert not isinstance(val, str), f"rank {r}, {name}:\n{val}"
    return ranks


def _predicted(name: str, rank: int) -> dict:
    shape, axes, (kind, arch, option, *dispatch) = RUNS[name]
    mesh = AbstractMesh(dict(zip(axes, shape)), rank=rank)
    cfg = get_smoke_config(arch)
    if dispatch:
        cfg = configure(cfg, dispatch[0])
    if kind == "train":
        return {"train": roofline.step_collectives(cfg, TRAIN, mesh, transport=option,
                                                   tcfg=TCFG)}
    if cfg.moe is not None:
        cfg = configure(cfg, option)
        sh = ShardingConfig()
    else:
        sh = ShardingConfig(kv_partition=option)
    return {"prefill": roofline.step_collectives(cfg, ShapeConfig("p", PROMPT, ROWS, "prefill"),
                                                 mesh, sh=sh),
            "decode": roofline.step_collectives(cfg, ShapeConfig("d", CAPACITY, ROWS, "decode"),
                                                mesh, sh=sh)}


@pytest.mark.parametrize("name", list(RUNS))
def test_layout_bytes_equal_sent(four_ranks, name):
    """Every rank's bytes by ``op@axis``, phase by phase, equal the layout's
    count for its coordinates."""
    for out in four_ranks:
        rank, measured = out[name]
        predicted = _predicted(name, rank)
        assert set(measured) == set(predicted)
        for phase, sent in measured.items():
            assert Counter(sent) == predicted[phase], (rank, phase)
        assert any(sum(s.values()) for s in measured.values())
