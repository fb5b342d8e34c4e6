"""The moe family's training loss on a mesh: the expert dispatches'
backward on four gloo ranks, held to ``jax.grad`` of the reference's loss
on a four-device CPU mesh.

On (data 2, model 2), ``qwen3-moe-smoke`` (2 layers, 8 experts, top 2,
capacity factor 1.25) from the reference's parameters (``PRNGKey(0)``), a
global batch of 4 rows of 16 positions dealt over ``data``:

- for each dispatch (``alltoall``, ``allgather``, and ``grouped``, which on
  dealt rows routes the global batch's tokens) and each layout (parameters
  replicated; FSDP over ``data`` with the expert banks over ``model``, as
  ``train.step.shardings_for`` lays them out): each rank's loss and
  gradient, averaged over ``data`` and agreed over ``model`` as the training
  step does, the logical gradient gathered. The loss within 1e-3 of the
  reference's (relative), each leaf's gradient within the bounds of
  ``tests/test_torch_hymba_train.py`` (relative L2 4e-2, largest difference
  6e-2 of the leaf's largest |g|: both sides multiply in bfloat16). The
  reference routes each (data, model) cell's tokens at the cell's own
  capacity, as the port's mesh dispatches do, so the same tokens drop;
- the losses are equal across each ``model`` group;
- the model trains on the compute split over ``model`` (``pshard.Split``:
  its heads, the sequence-parallel residual, the vocabulary), so the mesh
  dispatches take the rows as the rank's positions and, in training, the
  banks as its experts: the router is the one input that enters the
  dispatch whole. Without its sum over ``model`` the last layer's router
  gets a gradient |model| = 2 times too small: each rank keeps only its own
  tokens' share, and the step's agreement over ``model`` averages them.
  The banks and the layers below come out the same either way: nothing
  else enters whole;
- the collectives of the backward: ``grad_all_to_all@model`` under
  ``alltoall`` only, ``grad_reduce_scatter@model`` under ``allgather``
  (the rows' gather) and ``grouped`` (the banks, read whole as a shared
  part of the gathered rows' dispatch), ``grad_reduce_scatter@data`` under
  ``grouped`` only; the sequence split's ``grad_gather_seq@model`` and
  ``grad_scatter_seq@model`` under each, and no ``grad_all_gather@model``
  (no rows' slice, no bank's experts) under the mesh dispatches.
"""
import os

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import traceback

import numpy as np
import pytest
import torch

from repro_torch.comm.moe_dispatch import configure
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import ShapeConfig, ShardingConfig
from repro_torch.launch.mesh import spawn
from repro_torch.models import moe as tmoe

ARCH = "qwen3-moe-235b-a22b"
DISPATCHES = ("alltoall", "allgather", "grouped")
LAYOUTS = ("replicated", "fsdp")
B, S = 4, 16
SHAPE = ShapeConfig("t", S, B, "train")
#: a leaf's gradient against the reference's: relative L2, and the largest
#: difference relative to the leaf's largest |g| (tests/test_torch_hymba_train.py)
GRAD_L2, GRAD_MAX = 4e-2, 6e-2
#: the router's gradient without the sums against with them, times
#: |model|: the same sums, rounded in float32 in other orders (up to 3.8e-5
#: relative on an element 4e-5 of the leaf's largest |g|)
FACTOR_RTOL, FACTOR_ATOL = 1e-4, 1e-6


def _batch() -> dict:
    vocab = get_smoke_config(ARCH).vocab_size
    toks = np.random.default_rng(0).integers(0, vocab, (B, S + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _grads(tr, batch) -> tuple:
    """(loss averaged over ``data``, the logical gradient's leaves by name,
    numpy, the bytes each collective sent): one rank's loss and backward,
    then the training step's mean over ``data`` and agreement over
    ``model``, each leaf gathered to its full tensor."""
    from repro_torch.comm import collectives
    from repro_torch.models import registry
    from repro_torch.train import step as step_mod

    mesh, model, layout = tr.mesh, tr.model, tr._layout
    local = step_mod.local_rows(batch, mesh)
    for p in model.parameters():
        p.grad = None
    sent0 = dict(collectives.SENT)
    loss = registry.loss(model, local, batch_split=2)
    loss.backward()
    sent = {k: v - sent0.get(k, 0) for k, v in collectives.SENT.items() if v > sent0.get(k, 0)}
    grads = {n: p.grad for n, p in model.named_parameters()}
    grads = step_mod._mean_auto(grads, mesh, "data", layout)
    grads = step_mod._agree_over(grads, mesh, "model", layout)
    if layout is not None:
        grads = {n: layout.full(n, g) for n, g in grads.items()}
    mean = step_mod._mean_over(loss.detach().reshape(1), mesh, ["data"])
    return (float(loss), float(mean), {n: g.numpy() for n, g in grads.items()}, sent)


def _no_sums():
    """The dispatch's inputs sliced with no sum over ``model`` in their
    backward (under the split only the router's is called)."""
    def router(p, mesh, axis):
        return p.router.w

    def seq_slice(x3d, mesh, axis):
        n, r = mesh.shape[axis], mesh.coords[axis]
        s_l = x3d.shape[1] // n
        return x3d[:, r * s_l:(r + 1) * s_l].reshape(-1, x3d.shape[2])

    def local_banks(p, mesh, axis):
        n, r = mesh.shape[axis], mesh.coords[axis]
        return tuple(w[r * (w.shape[0] // n):(r + 1) * (w.shape[0] // n)] for w in p.banks())

    return {"_router": router, "_seq_slice": seq_slice, "_local_banks": local_banks}


def _rank(params) -> dict:
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train.trainer import ReconfigurableTrainer

    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    batch = _batch()
    out = {"coords": dict(mesh.coords)}

    def trainer(impl, layout):
        tr = ReconfigurableTrainer(configure(get_smoke_config(ARCH), impl), SHAPE, mesh,
                                   sharding=ShardingConfig(fsdp=layout == "fsdp"),
                                   transport="xla")
        tr.init_state(params=params)
        return tr

    for impl in DISPATCHES:
        for layout in LAYOUTS:
            try:
                out[(impl, layout)] = _grads(trainer(impl, layout), batch)
            except Exception:
                out[(impl, layout)] = traceback.format_exc()
    saved = {name: getattr(tmoe, name) for name in _no_sums()}
    try:
        for name, fn in _no_sums().items():
            setattr(tmoe, name, fn)
        for impl in ("alltoall", "allgather"):
            out[(impl, "no sums")] = _grads(trainer(impl, "replicated"), batch)
    except Exception:
        out["no sums"] = traceback.format_exc()
    finally:
        for name, fn in saved.items():
            setattr(tmoe, name, fn)
    return out


@pytest.fixture(scope="module")
def jax():
    return pytest.importorskip("jax")


@pytest.fixture(scope="module")
def ref_params(jax):
    from repro.configs import get_smoke_config as ref_config
    from repro.models.registry import build as ref_build

    return jax.tree.map(np.asarray, ref_build(ref_config(ARCH)).init(jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def four_ranks(ref_params):
    ranks = spawn("test_torch_moe_train_sharded:_rank", 4, backend="gloo", args=(ref_params,),
                  threads=1, timeout_s=600.0)
    for r, out in enumerate(ranks):
        for key, val in out.items():
            assert not isinstance(val, str), f"rank {r}, {key}:\n{val}"
    return ranks


@pytest.fixture(scope="module")
def reference(jax, ref_params):
    """``jax.value_and_grad`` of the reference's ``moe.loss_fn`` on a (data
    2, model 2) CPU mesh, by dispatch: (loss, the gradient's leaves by
    dotted path)."""
    import dataclasses

    import jax.numpy as jnp
    from repro.configs import get_smoke_config as ref_config
    from repro.launch.mesh import make_test_mesh
    from repro.models import moe as rmoe

    mesh = make_test_mesh((2, 2), ("data", "model"))
    p = jax.tree.map(jnp.asarray, ref_params)
    batch = {k: jnp.asarray(v) for k, v in _batch().items()}
    out = {}
    for impl in DISPATCHES:
        cfg = ref_config(ARCH)
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, dispatch=impl))
        fn = jax.jit(jax.value_and_grad(lambda p_, b_, cfg=cfg: rmoe.loss_fn(p_, b_, cfg,
                                                                            mesh=mesh)))
        loss, g = fn(p, batch)
        leaves = jax.tree_util.tree_flatten_with_path(g)[0]
        out[impl] = (float(loss), {".".join(str(k.key) for k in path): np.asarray(w)
                                   for path, w in leaves})
    return out


def _tree(grads: dict) -> dict:
    """The port's gradient by name, stacked into the reference's leaves."""
    from repro_torch import tree as T
    from repro_torch.models.stacking import stack_layers

    model_stacks = {"layers": get_smoke_config(ARCH).num_layers}
    tree = stack_layers({n: torch.from_numpy(g) for n, g in grads.items()}, model_stacks)
    return {".".join(map(str, path)): g.numpy() for path, g in T.flatten_with_paths(tree)}


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("impl", DISPATCHES)
def test_loss_and_grads_match_reference_on_the_mesh(four_ranks, reference, impl, layout):
    want_loss, want = reference[impl]
    for r in four_ranks:
        _, loss, grads, _ = r[(impl, layout)]
        assert abs(loss - want_loss) <= 1e-3 * abs(want_loss), (r["coords"], loss, want_loss)
        got = _tree(grads)
        assert sorted(got) == sorted(want)
        for path, w in want.items():
            g = got[path]
            assert g.shape == w.shape, path
            assert np.linalg.norm(g - w) <= GRAD_L2 * np.linalg.norm(w), (path, r["coords"])
            assert np.abs(g - w).max() <= GRAD_MAX * np.abs(w).max(), (path, r["coords"])


@pytest.mark.parametrize("impl", DISPATCHES)
def test_losses_equal_across_each_model_group(four_ranks, impl):
    for layout in LAYOUTS:
        by_data: dict = {}
        for r in four_ranks:
            by_data.setdefault(r["coords"]["data"], set()).add(r[(impl, layout)][0])
        assert all(len(v) == 1 for v in by_data.values()), by_data


@pytest.mark.parametrize("impl", ["alltoall", "allgather"])
def test_replicated_input_sums(four_ranks, impl):
    """Without the sums over ``model`` of the router's gradient (each rank's
    share from its own tokens), the step's agreement over ``model`` leaves
    it |model| times too small."""
    last = f"layers.{get_smoke_config(ARCH).num_layers - 1}.moe."
    for r in four_ranks:
        with_sums, without = r[(impl, "replicated")][2], r[(impl, "no sums")][2]
        want = with_sums[last + "router.w"]
        np.testing.assert_allclose(2 * without[last + "router.w"], want, rtol=FACTOR_RTOL,
                                   atol=FACTOR_ATOL * np.abs(want).max())
        for leaf in ("gate", "up", "down"):
            np.testing.assert_allclose(without[last + leaf], with_sums[last + leaf],
                                       rtol=FACTOR_RTOL,
                                       atol=FACTOR_ATOL * np.abs(with_sums[last + leaf]).max())
        # the rows arrive as the rank's positions, with no sum to drop: the
        # layers below get the same gradient
        name = "layers.0.attn.wq.w"
        np.testing.assert_array_equal(without[name], with_sums[name])


@pytest.mark.parametrize("impl", DISPATCHES)
def test_backward_collectives(four_ranks, impl):
    for r in four_ranks:
        sent = r[(impl, "replicated")][3]
        assert ("grad_all_to_all@model" in sent) == (impl == "alltoall")
        assert ("grad_reduce_scatter@model" in sent) == (impl != "alltoall")
        assert ("grad_reduce_scatter@data" in sent) == (impl == "grouped")
        assert {"grad_gather_seq@model", "grad_scatter_seq@model"} <= set(sent)
        if impl != "grouped":
            assert {"grad_all_reduce@model", "grad_all_reduce@data"} <= set(sent)
            assert "grad_all_gather@model" not in sent
