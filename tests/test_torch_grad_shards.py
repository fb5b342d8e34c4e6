"""The gradient transports on each rank's own shard of the gradient
(``repro_torch.train.gradshard``), held to the whole-tree path and to the
reference's int8 wire.

One ``spawn`` of four gloo ranks runs every case: a mesh, a gradient tree,
a transport and a block. The meshes: (pod 2, model 2); (pod 2, data 2) with
FSDP; and, for the hierarchical pair, which takes ``data`` manual, (pod 2,
data 1, model 2). The trees: ``llama3.2-1b-smoke``'s gradient tree, laid out
by the trainer's specs for the transport (``roofline.train_layout``), and a
synthetic tree that mixes own leaves with whole ones (a run shorter than
the block, a leaf whose length is no multiple of it, a last leaf that ends
the flat vector). Each rank draws every pod's full gradient from a seed,
keeps its blocks, and applies the transport twice on its own shard (the
step's path) and twice on the whole tree (every leaf gathered, the
transport on the logical flat vector, the rank's blocks cut out), each
path carrying its own state. Checked:

- each rank's reduced blocks and residual blocks, both applications,
  bit-equal to its slices of the whole-tree path;
- the int8 codes and scales the rank sends equal the jitted reference's
  ``compress.quantize_int8`` of the same blocks of the logical flat vector
  that the whole-tree path quantizes;
- without ranks: the hierarchical wire's chunk frame at |data| 2 and 4
  against the reference's pad and ``psum_scatter`` chunking; at block 16
  every leaf of the smoke model is own on the three meshes; at the
  published widths (llama3.2-1b, 2 layers) every leaf is own at block 256
  and a rank's step sends 807,532,564 bytes under ``psum`` and 234,049,716
  under ``compressed_int8`` on (pod 2, model 2), with no gather of the
  gradient or its state.
"""
import os

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import traceback

import numpy as np
import pytest
import torch

from repro_torch import tree as T
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import ShapeConfig, ShardingConfig, TrainConfig
from repro_torch.launch.mesh import AbstractMesh, spawn
from repro_torch.models.sharding import P, NamedSharding
from repro_torch.train.gradshard import GradShards

ARCH = "llama3.2-1b"
POD = ("psum", "ring", "compressed_int8", "localsgd")
HIER = ("hierarchical", "hier_compressed")
INT8 = ("compressed_int8", "hier_compressed")
#: name -> (mesh shape, axes, sharding, transports)
MESHES = {
    "pod2_model2": ((2, 2), ("pod", "model"), ShardingConfig(), POD),
    "pod2_data2_fsdp": ((2, 2), ("pod", "data"), ShardingConfig(fsdp=True), POD),
    "pod2_data1_model2": ((2, 1, 2), ("pod", "data", "model"), ShardingConfig(), HIER),
}
BLOCKS = (256, 16)
TREES = ("smoke", "synthetic")
APPLICATIONS = 2
SEED = 0


def _cases():
    """(mesh, tree, transport, block): the int8 transports at each block,
    the float32 ones (elementwise, no block) once."""
    for mesh, (_, _, _, transports) in MESHES.items():
        for tree in TREES:
            for t in transports:
                for block in (BLOCKS if t in INT8 else (None,)):
                    yield mesh, tree, t, block


CASES = list(_cases())


def _chunnel(name: str, block):
    from repro_torch.comm import chunnels as C

    if name == "psum":
        return C.GradPsum(axis="pod")
    if name == "ring":
        return C.GradRing(axis="pod")
    if name == "localsgd":  # syncs at the second application
        return C.GradLocalSGD(axis="pod", sync_every=2)
    if name == "compressed_int8":
        return C.GradCompressed(axis="pod", block=block, device="cpu")
    if name == "hierarchical":
        return C.GradHierarchical(fast_axis="data", slow_axis="pod")
    return C.GradHierCompressed(fast_axis="data", slow_axis="pod", block=block, device="cpu")


def _synthetic(axis: str):
    """(shapes, specs) in leaf order: own and whole leaves mixed. At block
    256: ``a`` and ``g`` own (runs of 256 and 1024 on aligned offsets),
    ``b``-``f`` whole (768 elements together, so ``g`` starts aligned), ``h``
    replicated, aligned, ending the flat vector."""
    leaves = {
        "a": ((4, 512), P(None, axis)),
        "b": ((7, 5), P()),
        "c": ((300,), P()),
        "d": ((8, 40), P(axis, None)),
        "e": ((3, 11), P()),
        "f": ((80,), P()),
        "g": ((2, 256, 8), P(None, axis, None)),
        "h": ((5,), P()),
    }
    return ({k: torch.empty(s, device="meta") for k, (s, _) in leaves.items()},
            {k: sp for k, (_, sp) in leaves.items()})


def _tree(kind: str, mesh_name: str, mesh, transport: str):
    """(full shapes as meta tensors, their specs less the manual axes)."""
    if kind == "synthetic":
        return _synthetic("data" if mesh_name == "pod2_data2_fsdp" else "model")
    from repro_torch.analysis.roofline import train_layout
    from repro_torch.models import registry

    model = registry.build(get_smoke_config(ARCH), device="meta")
    _, specs = train_layout(model, mesh, MESHES[mesh_name][2], transport)
    return registry.param_shapes(model), specs


def _draw(shapes, pod: int, app: int, seed: int):
    """Pod ``pod``'s full gradient of application ``app``."""
    rng = np.random.default_rng([seed, pod, app])
    return T.map(lambda s: torch.from_numpy(
        (rng.standard_normal(tuple(s.shape)) * rng.uniform(1e-3, 1.0)).astype(np.float32)),
        shapes)


class _Wire:
    """Records the codes and scales each compressed all-gather sends, and
    the vector it quantized."""

    def __init__(self):
        from repro_torch.comm import collectives

        self.C = collectives
        self.sent, self.quantized = [], []
        self._gather, self._sum = collectives.all_gather, collectives.compressed_allgather_sum

    def __enter__(self):
        def gather(x, mesh, axis, **kw):
            self.sent.append(x.detach().clone())
            return self._gather(x, mesh, axis, **kw)

        def summed(x, mesh, axis, **kw):
            self.quantized.append(x.detach().clone())
            self.sent.clear()
            out = self._sum(x, mesh, axis, **kw)
            codes, scales = self.sent  # the codes' all-gather, then the scales'
            self.wire.append((codes.numpy(), scales.numpy()))
            return out

        self.wire = []
        self.C.all_gather, self.C.compressed_allgather_sum = gather, summed
        return self

    def __exit__(self, *exc):
        self.C.all_gather, self.C.compressed_allgather_sum = self._gather, self._sum


def _tensor_leaves_equal(a, b) -> bool:
    la, lb = T.leaves(a), T.leaves(b)
    return len(la) == len(lb) and all(
        torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y for x, y in zip(la, lb))


def _positions(plan) -> np.ndarray:
    """The flat vector's index of each element of the plan's view."""
    starts, ends = plan.segments()
    return np.concatenate([np.arange(s, e, dtype=np.int64) for s, e in zip(starts, ends)])


def _run_case(mesh, mesh_name, kind, transport, block) -> dict:
    from repro_torch.comm.chunnels import apply_grad_stack, init_grad_states
    from repro_torch.train.gradshard import whole_tree
    from repro_torch.train.step import place

    shapes, specs = _tree(kind, mesh_name, mesh, transport)
    shards = GradShards([tuple(t.shape) for t in T.leaves(shapes)],
                        [NamedSharding(mesh, s) for s in T.leaves(specs)])
    ctx = {"mesh": mesh, "shards": shards}
    chunnels = (_chunnel(transport, block),)
    plan = shards.plan(*chunnels[0].frame(mesh))
    # zero residuals (their blocks) or a counter, one copy for each path
    own_state, whole_state = (
        tuple(st if st == () or "step" in st else place(st, shards.like(st))
              for st in init_grad_states(chunnels, shapes)) for _ in range(2))
    rec = {"out_equal": [], "state_equal": [], "wire": [], "whole_wire": [],
           "own": plan.own, "numel": plan.numel}
    for app in range(APPLICATIONS):
        full = _draw(shapes, mesh.coords["pod"], app, seed=SEED)
        grads = place(full, shards.like(full))
        with _Wire() as w:
            out, own_state = apply_grad_stack(chunnels, grads, own_state, ctx)
        rec["wire"] += w.wire
        with _Wire() as w:
            ref, whole_state = whole_tree(chunnels, grads, whole_state, ctx)
        rec["whole_wire"] += [x.numpy() for x in w.quantized]
        rec["out_equal"].append(_tensor_leaves_equal(out, ref))
        rec["state_equal"].append(_tensor_leaves_equal(own_state, whole_state))
    if transport in INT8:
        rec["positions"] = _positions(plan)
    return rec


def _rank_cases() -> dict:
    """Every case on this rank (spawn target): its record, or the traceback."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh

    out = {"rank": dist.get_rank()}
    meshes = {name: make_mesh(shape, axes, device="cpu")
              for name, (shape, axes, _, _) in MESHES.items()}
    for case in CASES:
        mesh_name, kind, transport, block = case
        try:
            out[case] = _run_case(meshes[mesh_name], mesh_name, kind, transport, block)
        except Exception:
            out[case] = traceback.format_exc()
    return out


@pytest.fixture(scope="module")
def four_ranks():
    ranks = spawn("test_torch_grad_shards:_rank_cases", 4, backend="gloo", threads=1,
                  timeout_s=400.0)
    for r, out in enumerate(ranks):
        for key, val in out.items():
            assert not isinstance(val, str), f"rank {r}, {key}:\n{val}"
    return ranks


def _ids(case) -> str:
    return "-".join(str(c) for c in case if c is not None)


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_own_shard_bit_equal_to_whole_tree(four_ranks, case):
    """Each rank's reduced blocks and residual blocks, at both applications,
    equal its slices of the whole-tree path bit for bit."""
    for out in four_ranks:
        rec = out[case]
        assert rec["out_equal"] == [True] * APPLICATIONS, (out["rank"], rec["out_equal"])
        assert rec["state_equal"] == [True] * APPLICATIONS, (out["rank"], rec["state_equal"])
    if case[1] == "synthetic" and case[3] == 256:  # both kinds of leaf ran
        own = four_ranks[0][case]["own"]
        assert any(own) and not all(own)


@pytest.mark.parametrize("case", [c for c in CASES if c[2] in INT8], ids=_ids)
def test_wire_equals_jitted_reference_blocks(four_ranks, case):
    """The codes and scales a rank sends are the jitted reference's
    ``quantize_int8`` of the logical flat vector at the blocks its view
    holds."""
    jax = pytest.importorskip("jax")
    from repro.comm import compress as ref

    block = case[3]
    quantize = jax.jit(lambda a: ref.quantize_int8(a, block=block))
    for out in four_ranks:
        rec = out[case]
        assert len(rec["wire"]) == len(rec["whole_wire"]) == APPLICATIONS
        pos = rec["positions"]
        assert len(pos) == rec["numel"]
        first = pos[::block]
        assert np.array_equal(first % block, np.zeros_like(first))  # block starts
        idx = first // block
        for (codes, scales), logical in zip(rec["wire"], rec["whole_wire"]):
            q_ref, s_ref = (np.asarray(a) for a in quantize(logical))
            assert codes.shape == (len(idx), block)
            np.testing.assert_array_equal(codes, q_ref[idx])
            np.testing.assert_array_equal(scales.view(np.int32), s_ref[idx].view(np.int32))


# -- without ranks -------------------------------------------------------------------


def _abstract_shards(kind: str, shape: dict, rank: int, transport: str, sh=ShardingConfig()):
    mesh = AbstractMesh(shape, rank=rank)
    if kind == "synthetic":
        shapes, specs = _synthetic("model")
    else:
        from repro_torch.analysis.roofline import train_layout
        from repro_torch.models import registry

        model = registry.build(get_smoke_config(ARCH), device="meta")
        shapes = registry.param_shapes(model)
        _, specs = train_layout(model, mesh, sh, transport)
    return GradShards([tuple(t.shape) for t in T.leaves(shapes)],
                      [NamedSharding(mesh, s) for s in T.leaves(specs)])


@pytest.mark.parametrize("n_data", (2, 4))
@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("kind", TREES)
def test_hier_frame_is_reference_chunking(kind, block, n_data):
    """At |data| > 1 every rank's view, cut by the plan's chunk lengths, is
    whole blocks of the reference's chunks: the flat vector padded to a
    multiple of |data| and ``psum_scatter``-ed into |data| rows, each row
    quantized in blocks from its start."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    shape = {"pod": 2, "data": n_data, "model": 2}
    for rank in range(2 * n_data * 2):
        plan = _abstract_shards(kind, shape, rank, "hier_compressed").plan(block, n_data)
        n = plan.total
        pad = (-n) % n_data
        marks = jnp.concatenate([jnp.arange(1, n + 1, dtype=jnp.int32),
                                 jnp.zeros(pad, jnp.int32)])  # 0 marks the padding
        # rank 0 holds the vector, the others zeros: each row is its chunk
        x = jnp.stack([marks] + [jnp.zeros_like(marks)] * (n_data - 1))
        rows = np.asarray(jax.vmap(
            lambda v: jax.lax.psum_scatter(v.reshape(n_data, -1), "data", scatter_dimension=0,
                                           tiled=False), axis_name="data")(x))
        assert rows.shape == (n_data, plan.width)
        pos = _positions(plan)
        lengths = plan.chunk_lengths()
        assert sum(lengths) == len(pos) == plan.numel
        start = 0
        for d, length in enumerate(lengths):
            part = pos[start:start + length] + 1
            start += length
            assert ((part > d * plan.width) & (part <= (d + 1) * plan.width)).all()
            padded = np.pad(part, (0, (-length) % block))
            row = np.pad(rows[d], (0, (-plan.width) % block)).reshape(-1, block)
            for b in padded.reshape(-1, block):
                np.testing.assert_array_equal(b, row[(b[0] - 1 - d * plan.width) // block])


@pytest.mark.parametrize("mesh", list(MESHES))
def test_smoke_leaves_all_own_at_block_16(mesh):
    """Every leaf of llama3.2-1b-smoke's gradient is own at block 16 on the
    three meshes, for every rank (block 256 gathers most of them)."""
    shape, axes, sh, transports = MESHES[mesh]
    for rank in range(4):
        shards = _abstract_shards("smoke", dict(zip(axes, shape)), rank, transports[-1], sh)
        assert all(shards.plan(16, 1).own)
        assert not all(shards.plan(256, 1).own)


@pytest.mark.parametrize("mesh", ("pod2_model2", "pod2_data2_fsdp"))
def test_published_widths_all_own_and_step_bytes(mesh):
    """llama3.2-1b at its published widths, 2 layers, global batch 8 x 128:
    every stacked leaf is own at block 256 on every rank; on (pod 2, model
    2) a rank's step sends 807,532,564 bytes under ``psum`` (768,647,176 of
    them its 192,161,792 floats' all-reduce over pod) and 234,049,716 under
    ``compressed_int8`` (195,164,320: 750,632 blocks of 260 bytes), with no
    ``gather_grad`` or ``gather_state``."""
    from repro_torch.analysis import roofline
    from repro_torch.analysis.roofline import train_layout
    from repro_torch.models import registry

    shape, axes, sh, _ = MESHES[mesh]
    cfg = get_config(ARCH).replace(num_layers=2)
    model = registry.build(cfg, device="meta")
    shapes = registry.param_shapes(model)
    cell = ShapeConfig("sharded", 128, 8, "train")
    tcfg = TrainConfig(warmup_steps=10, total_steps=8)
    for rank in range(4):
        m = AbstractMesh(dict(zip(axes, shape)), rank=rank)
        _, specs = train_layout(model, m, sh, "compressed_int8")
        shards = GradShards([tuple(t.shape) for t in T.leaves(shapes)],
                            [NamedSharding(m, s) for s in T.leaves(specs)])
        plan = shards.plan(256, 1)
        assert len(plan.own) == 11 and all(plan.own)
        if mesh != "pod2_model2":
            continue
        assert plan.numel == 192_161_792 and -(-plan.numel // 256) == 750_632
        want = {"psum": (807_532_564, "all_reduce@pod", 768_647_176),
                "compressed_int8": (234_049_716, "all_gather@pod", 195_164_320)}
        for transport, (total, key, wire) in want.items():
            c = roofline.step_collectives(cfg, cell, m, sh=sh, transport=transport, tcfg=tcfg,
                                          model=model)
            assert sum(c.values()) == total and c[key] == wire
            assert not any(k.startswith(("gather_grad", "gather_state")) for k in c)
