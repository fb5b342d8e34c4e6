"""The port's gradient collectives and transports against the jitted reference.

Four ranks (one ``spawn`` of four processes, ``gloo`` on the CPU) each build
two meshes over their world, (``pod`` 2, ``data`` 2) and (``pod`` 4), give
every collective and every ``Grad*`` chunnel a tree of their own (numpy,
seeded by rank), and return what came out. The reference runs the same
functions inside a jitted ``shard_map`` on a mesh of four fake CPU devices,
each device the same rank's tree. The tree's leaves (7 x 5, 300 and 2 x 64
floats) are not multiples of the int8 wire's block of 256, so its blocks
straddle leaves as the reference's do.

Tolerances, each with its reason:

- psum, pmean, ring, hierarchical: rtol 1e-5 (and atol 1e-6), float32 sums
  of up to four values taken in another order;
- compressed and hier-compressed: every code and scale on the wire is the
  reference's, but not every sum's last bit. The port adds the dequantized
  ranks in rank order, each product and each sum rounded
  (``unpack_dequant_sum``, bit-equal to its plain version), where the jitted
  reference fuses each later rank's product into the add, one rounding
  fewer (XLA's fused multiply-add on the CPU; the error feedback's
  ``x - q * s`` likewise). So each value agrees within ``ONE_ROUNDING``: two
  ulps of the value plus one ulp of ``4 * max |input|``, the largest a
  dequantized term can be — far below a quantization step (the scale, about
  1/127 of a block's largest value), so a wrong code or scale still fails.
  At n = 4 the reference may also sum in another order: the same bound,
  doubled;
- the localsgd schedule: exact on its local steps, rtol 1e-6 on the mean.

``unpack_dequant_sum``'s plain version is held bit-equal to n plain
dequantizes summed in rank order, in this process.
"""
import os

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import numpy as np
import pytest
import torch

from repro_torch import tree as T
from repro_torch.comm import collectives as C
from repro_torch.comm import chunnels as CH
from repro_torch.kernels.quantize.quantize import (
    unpack_dequant_ref,
    unpack_dequant_sum,
    unpack_dequant_sum_ref,
    quantize_pack_ref,
)
from repro_torch.launch.mesh import make_mesh, spawn

WORLD = 4
LOCALSGD_STEPS = 5


def rank_tree(rank: int) -> dict:
    rng = np.random.default_rng([17, rank])
    return {"a": rng.standard_normal((7, 5)).astype(np.float32),
            "b": {"c": (rng.standard_normal(300) * 3).astype(np.float32),
                  "d": (rng.standard_normal((2, 64)) * 1e-2).astype(np.float32)}}


#: (case, mesh, op) — the mesh is "a" (pod 2 x data 2) or "b" (pod 4)
COLLECTIVES = [
    ("psum", "a", lambda C, m, t: C.psum_tree(t, *m("pod"))),
    ("pmean", "a", lambda C, m, t: C.pmean_tree(t, *m("pod"))),
    ("ring", "a", lambda C, m, t: C.ring_tree(t, *m("pod"))),
    ("hierarchical", "a", lambda C, m, t: C.hierarchical_tree(t, *m("data", "pod"))),
    ("compressed", "a", lambda C, m, t: C.compressed_tree(t, *m("pod"))),
    ("hier_compressed", "a", lambda C, m, t: C.hierarchical_compressed_tree(
        t, *m("data", "pod"))),
    ("psum n4", "b", lambda C, m, t: C.psum_tree(t, *m("pod"))),
    ("ring n4", "b", lambda C, m, t: C.ring_tree(t, *m("pod"))),
    ("compressed n4", "b", lambda C, m, t: C.compressed_tree(t, *m("pod"))),
]
#: cases compared within ONE_ROUNDING (times the factor), not by rtol
ROUNDED = {"compressed": 1, "hier_compressed": 1, "compressed n4": 2,
           "chunnel compressed_int8": 1, "chunnel hier_compressed": 1}
#: transport name -> the chunnel's keyword arguments (beside device= on the port)
CHUNNELS = {"xla": {}, "psum": {}, "ring": {}, "hierarchical": {}, "compressed_int8": {},
            "hier_compressed": {}}


def one_rounding(want: np.ndarray) -> np.ndarray:
    scale = 4 * max(np.abs(a).max() for r in range(WORLD) for a in T.leaves(rank_tree(r)))
    return 2 * np.spacing(np.abs(want)) + np.spacing(np.float32(scale))


def assert_close(case: str, got, want) -> None:
    got, want = T.leaves(got), T.leaves(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype
        if case in ROUNDED:
            err = np.abs(g.astype(np.float64) - w)
            assert (err <= ROUNDED[case] * one_rounding(w)).all(), (case, err.max())
        elif case == "chunnel xla":
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)


def _np(tree):
    return T.map(lambda t: t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t), tree)


def _port_chunnel(name):
    kw = dict(CHUNNELS[name])
    if name in CH.DEVICE_TRANSPORTS:
        kw["device"] = "cpu"
    if name in ("hierarchical", "hier_compressed"):
        kw.update(fast_axis="data", slow_axis="pod")
    return CH.make_transport(name, **kw)


def _rank_collectives() -> dict:
    """One rank's outputs of every case (spawn target)."""
    import torch.distributed as dist

    rank = dist.get_rank()
    meshes = {"a": make_mesh((2, 2), ("pod", "data"), device="cpu"),
              "b": make_mesh((4,), ("pod",), device="cpu")}
    tree = T.map(torch.from_numpy, rank_tree(rank))
    out = {}
    for case, which, op in COLLECTIVES:
        mesh = meshes[which]
        out[case] = _np(op(C, lambda *axes: (mesh, *axes), tree))
    ctx = {"mesh": meshes["a"]}
    for name in CHUNNELS:
        ch = _port_chunnel(name)
        state = CH.init_grad_states([ch], tree)[0]
        steps = []
        for _ in range(2):  # twice: the second step reads the first's state
            got, state = ch.apply(tree, state, ctx)
            steps.append((_np(got), _np(state)))
        out[f"chunnel {name}"] = steps
    ch = CH.make_transport("localsgd", axis="pod", sync_every=4)
    state = ch.init_state(tree)
    sched = []
    for _ in range(LOCALSGD_STEPS):
        got, state = ch.apply(tree, state, ctx)
        sched.append(_np(got))
    out["localsgd"] = (sched, state["step"])
    return out


@pytest.fixture(scope="module")
def port_out():
    return spawn("test_torch_collectives:_rank_collectives", WORLD, backend="gloo",
                 timeout_s=300.0)


@pytest.fixture(scope="module")
def ref():
    """The reference's collectives and chunnels in a jitted shard_map over
    four fake devices: ``ref(fn, which)`` maps ``fn(tree, mesh)`` over the
    four ranks' trees and returns each rank's output."""
    jax = pytest.importorskip("jax")
    from jax.sharding import Mesh
    from jax.sharding import PartitionSpec as P

    from repro import compat

    if len(jax.devices()) < WORLD:
        pytest.fail(f"needs {WORLD} host devices (XLA_FLAGS), have {len(jax.devices())}")
    devs = np.array(jax.devices()[:WORLD])
    meshes = {"a": Mesh(devs.reshape(2, 2), ("pod", "data")), "b": Mesh(devs, ("pod",))}
    stacked = jax.tree.map(lambda *xs: np.stack(xs), *[rank_tree(r) for r in range(WORLD)])

    def run(fn, which, *extra):
        mesh = meshes[which]
        spec = P(mesh.axis_names)

        def inner(t, *e):
            one = jax.tree.map(lambda a: a[0], (t,) + e)
            res = fn(mesh, *one)
            return jax.tree.map(lambda a: a[None], res)

        f = compat.shard_map(inner, mesh=mesh, in_specs=(spec,) * (1 + len(extra)),
                             out_specs=spec, check_vma=False)
        res = jax.jit(f)(stacked, *extra)
        return [jax.tree.map(lambda a: np.asarray(a)[r], res) for r in range(WORLD)]

    run.stacked = stacked
    return run


@pytest.mark.parametrize("case,which", [(c, w) for c, w, _ in COLLECTIVES],
                         ids=[c for c, _, _ in COLLECTIVES])
def test_collective_matches_jitted_reference(port_out, ref, case, which):
    from repro.comm import collectives as RC

    op = next(o for c, _, o in COLLECTIVES if c == case)
    want = ref(lambda mesh, t: op(RC, lambda *axes: axes, t), which)
    for rank in range(WORLD):
        assert_close(case, port_out[rank][case], want[rank])


@pytest.mark.parametrize("name", list(CHUNNELS))
def test_grad_chunnel_output_and_state_match_reference(port_out, ref, name):
    """Two applications of each transport chunnel on the (pod 2, data 2)
    mesh: the output and the state after each, every rank."""
    import jax

    from repro.comm import chunnels as RCH

    kw = dict(CHUNNELS[name])
    if name in ("hierarchical", "hier_compressed"):
        kw.update(fast_axis="data", slow_axis="pod")
    ch = RCH.make_transport(name, **kw)

    def two_steps(mesh, t):
        ctx = {"mesh": mesh}
        state = RCH.init_grad_states([ch], jax.tree.map(
            lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), t))[0]
        state = jax.tree.map(lambda s: jax.numpy.zeros(s.shape, s.dtype), state)
        outs = []
        for _ in range(2):
            got, state = ch.apply(t, state, ctx)
            outs.append((got, state))
        return outs

    want = ref(two_steps, "a")
    for rank in range(WORLD):
        assert_close(f"chunnel {name}", port_out[rank][f"chunnel {name}"], want[rank])


def test_localsgd_schedule_matches_reference(port_out, ref):
    """Sync every 4: steps 0-2 return the local tree, step 3 the pod mean,
    step 4 the local tree again; the counter ends at 5."""
    import jax

    from repro.comm import chunnels as RCH

    ch = RCH.make_transport("localsgd", axis="pod", sync_every=4)

    def steps(mesh, t):
        state = ch.init_state(None)
        outs = []
        for _ in range(LOCALSGD_STEPS):
            got, state = ch.apply(t, state, {"mesh": mesh})
            outs.append(got)
        return outs, state["step"]

    want = ref(steps, "a")
    for rank in range(WORLD):
        sched, count = port_out[rank]["localsgd"]
        assert count == int(want[rank][1]) == LOCALSGD_STEPS
        local = rank_tree(rank)
        for i, (g, w) in enumerate(zip(sched, want[rank][0])):
            for a, b, l in zip(T.leaves(g), T.leaves(w), T.leaves(local)):
                np.testing.assert_allclose(a, b, rtol=1e-6, atol=0)
                if i != 3:
                    np.testing.assert_array_equal(a, l)
        assert not np.array_equal(T.leaves(sched[3])[1], T.leaves(local)[1])


@pytest.mark.parametrize("n", [1, 2, 3, 4])
@pytest.mark.parametrize("block", [4, 64, 101, 256])
def test_unpack_dequant_sum_plain_is_rank_ordered_sum(n, block):
    """Bit-equal to n plain dequantizes (``unpack_dequant_ref``) summed in
    rank order, from codes and scales of n quantized rows."""
    rng = np.random.default_rng(block * 10 + n)
    n_blocks = 37
    packed = [quantize_pack_ref(torch.from_numpy(
        (rng.standard_normal((n_blocks, block)) * 10.0 ** rng.integers(-3, 3)).astype(np.float32)))
        for _ in range(n)]
    nq = n_blocks * block
    codes = torch.stack([p[:nq].view(torch.int8).view(n_blocks, block) for p in packed])
    scales = torch.stack([p[nq:].clone().view(torch.float32) for p in packed])
    want = unpack_dequant_ref(packed[0], n_blocks, block)
    for p in packed[1:]:
        want = want + unpack_dequant_ref(p, n_blocks, block)
    got = unpack_dequant_sum(codes, scales)
    assert got.shape == (nq,) and got.dtype == torch.float32
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert torch.equal(unpack_dequant_sum_ref(codes, scales).view(torch.int32),
                       want.view(torch.int32))


def test_unpack_dequant_sum_cpu_counts_no_launch():
    before = unpack_dequant_sum.launches
    unpack_dequant_sum(torch.zeros(2, 3, 64, dtype=torch.int8), torch.ones(2, 3))
    assert unpack_dequant_sum.launches == before


@pytest.mark.parametrize("args", [
    (torch.zeros(2, 3, 64, dtype=torch.uint8), torch.ones(2, 3)),
    (torch.zeros(2, 3, 64, dtype=torch.int8), torch.ones(2, 3, dtype=torch.float64)),
    (torch.zeros(3, 64, dtype=torch.int8), torch.ones(3)),
    (torch.zeros(2, 3, 64, dtype=torch.int8), torch.ones(2, 4)),
    (torch.zeros(2, 64, 3, dtype=torch.int8).transpose(1, 2), torch.ones(2, 3)),
    (torch.zeros(2, 3, 64, dtype=torch.int8, device="meta"),
     torch.ones(2, 3, device="meta")),
], ids=["uint8", "float64", "2d", "scales-shape", "strided", "meta"])
def test_unpack_dequant_sum_rejects(args):
    with pytest.raises(ValueError):
        unpack_dequant_sum(*args)


def test_dcn_bytes_factor_matches_reference():
    from repro.comm import collectives as RC

    for sched in ("xla", "psum", "ring", "hierarchical", "compressed", "hier_compressed",
                  "localsgd"):
        kw = dict(n_fast=4, sync_every=3, wire_ratio=0.26)
        assert C.dcn_bytes_factor(sched, **kw) == RC.dcn_bytes_factor(sched, **kw)
