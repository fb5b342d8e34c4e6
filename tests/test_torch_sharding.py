"""The port's sharding rules held exactly to the reference's.

- ``param_spec`` over the parameter tree of each of the reference's ten
  published configs (``Model.param_shapes``, an ``eval_shape``), under five
  mesh shapes with ``fsdp`` on and off: equal leaf for leaf to the
  reference's ``PartitionSpec``, the paths too;
- the port's own trees (``registry.param_specs`` of its models of the five
  configs it builds, on the meta device) give the same specs by their names;
- ``data_spec``, ``kv_partition_mode``, ``cache_spec_for`` (on the cache
  leaves of each ported arch) and ``_zero1_pod``: equal to the reference's;
- ``local_slice``: the block ``jax.device_put`` gives each of 8 fake devices
  under a ``NamedSharding``, for every device.

A mesh here is its axis sizes only (a stand-in for the port's rules, another
with ``axis_names``, ``shape`` and ``devices`` for the reference, whose rules
read nothing else), so the production meshes need no devices.
"""
import os

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch import tree as T
from repro_torch.configs import ARCH_IDS as PORTED
from repro_torch.configs import get_config
from repro_torch.configs.base import ShardingConfig
from repro_torch.models import registry, sharding
from repro_torch.models.sharding import P
from repro_torch.train.step import _zero1_pod

ALL_ARCHS = ("qwen2-7b", "granite-34b", "llama3.2-1b", "mistral-nemo-12b", "hymba-1.5b",
             "qwen3-moe-235b-a22b", "dbrx-132b", "xlstm-125m", "seamless-m4t-medium",
             "phi-3-vision-4.2b")
MESHES = {"prod": {"data": 16, "model": 16}, "prod_pods": {"pod": 2, "data": 16, "model": 16},
          "test": {"data": 2, "model": 4}, "pod_model": {"pod": 2, "model": 2},
          "one": {"data": 1, "model": 1}}
_SHAPES: dict = {}


def MeshShape(shape: dict):
    """The port's view of a mesh's axis sizes (all its rules read)."""
    return SimpleNamespace(axis_names=tuple(shape), shape=dict(shape))


def ref_mesh(shape: dict):
    return SimpleNamespace(axis_names=tuple(shape), shape=dict(shape),
                           devices=np.empty(tuple(shape.values())))


def axes_of(spec: P) -> tuple:
    return tuple(a for e in spec for a in (() if e is None else e if isinstance(e, tuple)
                                            else (e,)))


def ref_shapes(arch):
    """The reference's parameter tree of ``arch`` (ShapeDtypeStructs)."""
    if arch not in _SHAPES:
        from repro.configs import get_config as ref_config
        from repro.models.registry import build as ref_build

        _SHAPES[arch] = ref_build(ref_config(arch)).param_shapes()
    return _SHAPES[arch]


def ref_leaves(tree):
    import jax
    from jax.sharding import PartitionSpec

    pairs = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, PartitionSpec))[0]
    return [(tuple(str(getattr(k, "key", getattr(k, "idx", getattr(k, "name", k))))
                   for k in path), leaf) for path, leaf in pairs]


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_param_specs_equal_reference(arch, mesh):
    pytest.importorskip("jax")
    from repro.configs.base import ShardingConfig as RefSharding
    from repro.models import sharding as ref

    shapes = ref_shapes(arch)
    for fsdp in (True, False):
        want = ref_leaves(ref.param_specs(shapes, RefSharding(fsdp=fsdp),
                                          ref_mesh(MESHES[mesh])))
        got = T.flatten_with_paths(sharding.param_specs(shapes, ShardingConfig(fsdp=fsdp),
                                                        MeshShape(MESHES[mesh])))
        assert len(got) == len(want) > 0
        for (path, spec), (ref_path, ref_spec) in zip(got, want):
            assert tuple(str(k) for k in path) == ref_path
            assert spec == P(*ref_spec), (path, spec, ref_spec)
        # and with no mesh: the rules unpadded by axis sizes
        got = T.leaves(sharding.param_specs(shapes, ShardingConfig(fsdp=fsdp)))
        want = ref_leaves(ref.param_specs(shapes, RefSharding(fsdp=fsdp)))
        assert got == [P(*s) for _, s in want]


@pytest.mark.parametrize("arch", PORTED)
def test_port_trees_give_reference_specs(arch):
    """The port's model of ``arch`` (meta tensors), by its parameter names
    stacked as the reference stacks them, gives the reference's specs."""
    pytest.importorskip("jax")
    from repro.configs.base import ShardingConfig as RefSharding
    from repro.models import sharding as ref

    model = registry.model_class(get_config(arch))(get_config(arch), device="meta")
    for mesh in MESHES.values():
        for fsdp in (True, False):
            got = T.flatten_with_paths(registry.param_specs(model, ShardingConfig(fsdp=fsdp),
                                                            MeshShape(mesh)))
            want = ref_leaves(ref.param_specs(ref_shapes(arch), RefSharding(fsdp=fsdp),
                                              ref_mesh(mesh)))
            assert [(tuple(map(str, p)), s) for p, s in got] == [
                (p, P(*s)) for p, s in want]


@pytest.mark.parametrize("mesh", list(MESHES))
def test_data_spec_equal_reference(mesh):
    pytest.importorskip("jax")
    from repro.models import sharding as ref

    for shape in [(8, 128), (6, 128), (256, 4096), (64,), (4, 2, 16), (0, 3)]:
        for batch_dim in range(len(shape)):
            want = ref.data_spec(shape, ref_mesh(MESHES[mesh]), batch_dim=batch_dim)
            got = sharding.data_spec(shape, MeshShape(MESHES[mesh]), batch_dim=batch_dim)
            assert got == P(*want), (shape, batch_dim)
    assert sharding.batch_axes(MeshShape(MESHES[mesh])) == ref.batch_axes(
        ref_mesh(MESHES[mesh]))


@pytest.mark.parametrize("arch", [a for a in PORTED if get_config(a).family != "ssm"])
def test_kv_partition_and_cache_specs_equal_reference(arch):
    """Each ported arch's cache leaves (K and V) under every mesh and every
    ``kv_partition``, with the shapes of a decode batch of 4 and 32 and a
    capacity of 64 and 100."""
    pytest.importorskip("jax")
    from repro.configs import get_config as ref_config
    from repro.configs.base import ShapeConfig as RefShape
    from repro.configs.base import ShardingConfig as RefSharding
    from repro.models import sharding as ref
    from repro.models.registry import build as ref_build

    ref_model = ref_build(ref_config(arch))
    cfg = get_config(arch)
    for batch, cap in [(4, 64), (32, 100)]:
        leaves = [leaf for path, leaf in ref_leaves(ref_model.cache_specs(
            RefShape("d", cap, batch, "decode"))) if path[-1] in ("k", "v")]
        assert leaves
        for mesh in MESHES.values():
            for kv in ("auto", "heads", "sequence"):
                sh, rsh = ShardingConfig(kv_partition=kv), RefSharding(kv_partition=kv)
                assert sharding.kv_partition_mode(cfg, MeshShape(mesh), sh) == \
                    ref.kv_partition_mode(ref_config(arch), ref_mesh(mesh), rsh)
                for leaf in leaves:
                    want = ref.cache_spec_for(leaf.shape, ref_config(arch), ref_mesh(mesh), rsh)
                    got = sharding.cache_spec_for(leaf.shape, cfg, MeshShape(mesh), sh)
                    assert got == P(*want), (leaf.shape, mesh, kv)


@pytest.mark.parametrize("mesh", ["prod_pods", "pod_model", "pod_data", "pod8"])
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_zero1_pod_equal_reference(arch, mesh):
    pytest.importorskip("jax")
    from repro.configs.base import ShardingConfig as RefSharding
    from repro.models import sharding as ref
    from repro.train.step import _zero1_pod as ref_zero1

    sizes = {**MESHES, "pod_data": {"pod": 2, "data": 2}, "pod8": {"pod": 8, "data": 1}}[mesh]
    shapes = ref_shapes(arch)
    specs = ref_leaves(ref.param_specs(shapes, RefSharding(), ref_mesh(sizes)))
    for (_, spec), (_, leaf) in zip(specs, ref_leaves(shapes)):
        want = ref_zero1(spec, leaf.shape, ref_mesh(sizes))
        got = _zero1_pod(P(*spec), leaf.shape, MeshShape(sizes))
        assert got == P(*want), (leaf.shape, spec)


def test_spec_equality_follows_partition_spec():
    pytest.importorskip("jax")
    from jax.sharding import PartitionSpec

    cases = [(("a", None), ("a",)), ((("a",),), ("a",)), ((), (None,)),
             ((("a", "b"),), (("a", "b"),)), ((("a", "b"),), (("b", "a"),)),
             ((None, "m"), (None, "m"))]
    for x, y in cases:
        assert (P(*x) == P(*y)) == (PartitionSpec(*x) == PartitionSpec(*y)), (x, y)


#: (mesh shape, axes) of 8 fake devices, and the specs placed on each
PLACEMENTS = [
    ((2, 4), ("data", "model")),
    ((2, 2, 2), ("pod", "data", "model")),
    ((8,), ("data",)),
    ((4, 2), ("pod", "model")),
]
SPECS = [P("data", "model"), P(("data", "pod"), None), P(None, ("pod", "model")),
         P("model"), P(), P(None, "data", "model"), P(("model", "data")), P("pod", None, None),
         P("data"), P(None, None, "data")]


@pytest.mark.parametrize("mesh_shape,axes", PLACEMENTS)
def test_local_slice_equals_jax_shard_index(mesh_shape, axes):
    jax = pytest.importorskip("jax")
    from jax.sharding import Mesh, NamedSharding, PartitionSpec

    devices = np.array(jax.devices()[:8]).reshape(mesh_shape)
    mesh = Mesh(devices, axes)
    sizes = dict(zip(axes, mesh_shape))
    shape = (16, 8, 24)
    checked = 0
    for spec in SPECS:
        if any(a not in axes for a in axes_of(spec)):
            continue
        ndim = max(len(spec), 1)
        full = shape[:ndim] if len(spec) else shape
        arr = jax.device_put(np.arange(np.prod(full)).reshape(full),
                             NamedSharding(mesh, PartitionSpec(*spec)))
        for s in arr.addressable_shards:
            pos = np.argwhere(devices == s.device)[0]
            coords = dict(zip(axes, (int(c) for c in pos)))
            got = sharding.local_slice(full, spec, sizes, coords)
            want = tuple(s.index) + (slice(None),) * (len(full) - len(s.index))
            assert [g.indices(n) for g, n in zip(got, full)] == [
                w.indices(n) for w, n in zip(want, full)], (spec, coords)
            np.testing.assert_array_equal(np.asarray(s.data),
                                          np.arange(np.prod(full)).reshape(full)[got])
            checked += 1
    assert checked >= 8 * 3, checked


def test_named_sharding_local_and_shapes():
    mesh = SimpleNamespace(shape={"pod": 2, "data": 2, "model": 2},
                           coords={"pod": 1, "data": 0, "model": 1})
    ns = sharding.NamedSharding(mesh, P(("data", "pod"), "model"))
    full = torch.arange(8 * 6).reshape(8, 6)
    assert torch.equal(ns.local(full), full[2:4, 3:6])
    assert ns.splits(2) == ((0, "data"), (0, "pod"), (1, "model"))
    assert sharding.NamedSharding(mesh, P()).local(7) == 7
    with pytest.raises(ValueError, match="does not split"):
        ns.index((6, 6))
