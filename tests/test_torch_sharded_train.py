"""The port's sharded trainer on four ranks, held to the reference trainer.

One ``spawn`` of four processes (``gloo`` on the CPU) runs every scenario on
``llama3.2-1b-smoke`` from the reference's parameters, each rank the same
calls, and returns what the checks below read:

- (data 2, model 2), ``xla``: parameters split over ``data`` (FSDP) and
  ``model``; saved at the end;
- (pod 2, data 2), ``psum``: moments on their ZeRO-1 blocks over
  (``data``, ``pod``);
- (pod 2, model 2): the first run's checkpoint restored onto this other
  sharding, then ``psum`` and a 2PC switch to ``compressed_int8``;
- (pod 2, model 2), ``compressed_int8`` with its wire at block 16, the step
  built by ``make_train_step`` as the trainer builds it: every leaf of the
  smoke model is then own (``train.gradshard``), so the transport runs on
  each rank's own shard end to end; the reference trainer runs the same
  wire;
- the reference's ``test_restore_with_resharding`` on (data 2, model 2).

Each scenario: its losses within 2e-2 (relative) of the reference trainer's
on the same mesh shape (the bf16 gradients' rounding through 10 updates, as
``test_torch_train.py`` holds the unsharded trainer), and within 1e-4 of the
port's own one-rank run under an exact transport (only the order of the sums
differs); every rank's blocks
equal to its slices of the gathered state (parameters, moments, chunnel
state); parameters bit-equal across ``pod`` after every step; the moments'
block shapes equal to the reference's ZeRO-1 shardings. The checkpoint
restores leaf for leaf onto (pod 2, model 2) and onto one rank.
"""
import os

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import math
import tempfile
import traceback
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import tree as T
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import ShapeConfig, TrainConfig
from repro_torch.data.synthetic import batches_for
from repro_torch.launch.mesh import make_mesh, spawn
from repro_torch.models.sharding import P, NamedSharding
from repro_torch.train.trainer import HostSpec, ReconfigurableTrainer

ARCH = "llama3.2-1b"
SHAPE = ShapeConfig("t", 64, 4, "train")
TCFG = TrainConfig(learning_rate=1e-3, warmup_steps=2, total_steps=50)
STEPS = 10
#: name -> (mesh shape, axes, transports in order, steps of each)
SCENARIOS = {
    "data2_model2_xla": ((2, 2), ("data", "model"), ("xla",), (STEPS,)),
    "pod2_data2_psum": ((2, 2), ("pod", "data"), ("psum",), (STEPS,)),
    "pod2_model2_psum_compressed": ((2, 2), ("pod", "model"), ("psum", "compressed_int8"),
                                    (STEPS // 2, STEPS // 2)),
    "pod2_model2_compressed_b16": ((2, 2), ("pod", "model"), ("compressed_int8",), (STEPS,)),
}
#: scenario -> the int8 wire's block where it is not the trainer's 256
WIRE_BLOCK = {"pod2_model2_compressed_b16": 16}
RTOL = 2e-2


class _WireTrainer(ReconfigurableTrainer):
    """The trainer with its ``compressed_int8`` wire at ``block``: the
    chunnel replaced and the step built again by ``make_train_step``."""

    block = 256

    def _build_step(self) -> None:
        import dataclasses

        from repro_torch.train import step as step_mod

        super()._build_step()
        if self.transport_name != "compressed_int8" or self.block == self.chunnels[0].block:
            return
        self.chunnels = (dataclasses.replace(self.chunnels[0], block=self.block),)
        self.state_sh = step_mod.shardings_for(self.model, self.mesh, self.sharding,
                                               self.chunnels)
        self._layout = step_mod.model_layout(self.state_sh)
        self.step_fn = step_mod.make_train_step(self.model, self.tcfg, self.chunnels, self.mesh,
                                                self.state_sh)


def _checksums(tensors: dict) -> dict:
    """Each tensor's bit patterns summed as int64: equal when the tensors are
    bit-equal (a difference in one element always shows)."""
    out = {}
    for n, t in tensors.items():
        t = t.detach().contiguous()
        bits = t.view(torch.int16 if t.element_size() == 2 else torch.int32)
        out[n] = int(bits.sum(dtype=torch.int64))
    return out


def _blocks_match(tr, state) -> bool:
    """Every rank's blocks equal its slices of the gathered state."""
    full = tr.gathered_state(state)
    sh = tr.state_sh.state()
    for mine, whole, s in zip(T.leaves(state), T.leaves(full), T.leaves(sh)):
        if isinstance(mine, torch.Tensor) and not torch.equal(mine, s.local(whole)):
            return False
    return True


def _scenario(name, ref_params, ckpt_dir, restore_from=None) -> dict:
    shape, axes, transports, steps = SCENARIOS[name]
    mesh = make_mesh(shape, axes, device="cpu")
    cfg = get_smoke_config(ARCH)
    trainer = type("Trainer", (_WireTrainer,), {"block": WIRE_BLOCK.get(name, 256)})
    tr = trainer(cfg, SHAPE, mesh, tcfg=TCFG, transport=transports[0],
                 ckpt_dir=ckpt_dir, hosts=[HostSpec(0, list(transports) + ["xla"])])
    state = tr.init_state(params=ref_params)
    out = {"coords": dict(mesh.coords), "restored": None,
           "wire_blocks": [ch.block for ch in tr.chunnels if hasattr(ch, "block")],
           "own": _own_leaves(tr)}
    if restore_from is not None:  # another mesh's checkpoint, then a fresh run
        from repro_torch.checkpoint.ckpt import Checkpointer

        tr.ckpt = Checkpointer(restore_from)
        restored, at = tr.restore()
        full = tr.gathered_state(restored)
        out["restored"] = (at, {n: t.detach().numpy() for n, t in full.params.items()},
                           {n: t.float().numpy() for n, t in full.opt.m.items()},
                           _blocks_match(tr, restored))
        tr.ckpt = Checkpointer(ckpt_dir)
        state = tr.init_state(params=ref_params)
    losses, pod_equal, blocks = [], [], []
    gen = batches_for(cfg, SHAPE)
    for t, n in zip(transports, steps):
        if t != tr.transport_name:
            state = tr.reconfigure(state, t)
        for _ in range(n):
            state, hist = tr.run(state, gen, 1)
            losses.append(hist[0]["loss"])
            pod_equal.append(_checksums(state.params))
            blocks.append(_blocks_match(tr, state))
    out.update(losses=losses, checksums=pod_equal, blocks=blocks,
               transport=tr.transport_name, log=list(tr.reconfig_log),
               moment_shapes={n: tuple(m.shape) for n, m in state.opt.m.items()},
               param_shapes={n: tuple(p.shape) for n, p in state.params.items()})
    tr.save(state)
    full = tr.gathered_state(state)
    out["saved"] = ({n: t.detach().numpy() for n, t in full.params.items()},
                    {n: t.float().numpy() for n, t in full.opt.m.items()})
    return out


def _own_leaves(tr) -> list:
    """Whether each gradient leaf is own under the trainer's int8 wire (its
    plan, ``train.gradshard``); empty for a float32 transport."""
    from repro_torch.train.gradshard import GradShards

    layout = tr._layout
    if layout is None or not any(hasattr(ch, "block") for ch in tr.chunnels):
        return []
    plan = GradShards.of_layout(layout, tr.model.stacks()).plan(*tr.chunnels[0].frame(tr.mesh))
    return list(plan.own)


def _resharding_restore(shared: str) -> list:
    """The reference's ``test_restore_with_resharding``: a (4, 4) leaf saved
    whole, restored onto (data 2, model 2) with ``P("data", None)``."""
    import torch.distributed as dist

    from repro_torch.checkpoint.ckpt import Checkpointer

    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    ck = Checkpointer(Path(shared) / "resharding")
    state = {"w": torch.arange(16.0).reshape(4, 4)}
    if mesh.rank == 0:
        ck.save(1, state)
    dist.barrier()
    sh = {"w": NamedSharding(mesh, P("data", None))}
    restored, _ = ck.restore({"w": torch.empty((4, 4), device="meta")}, shardings=sh)
    return restored["w"].tolist()


def _rank_scenarios(shared: str, ref_params: dict, names: tuple) -> dict:
    """The scenarios ``names`` on this rank (spawn target): each one's
    record, or the traceback; then the resharding restore."""
    out = {}
    dirs = {n: str(Path(shared) / n) for n in SCENARIOS}
    for name in names:
        restore = dirs["data2_model2_xla"] if name == "pod2_model2_psum_compressed" else None
        try:
            out[name] = _scenario(name, ref_params, dirs[name], restore)
        except Exception:
            out[name] = traceback.format_exc()
    try:
        out["resharding"] = _resharding_restore(shared)
    except Exception:
        out["resharding"] = traceback.format_exc()
    return out


#: the scenarios of this file (``test_torch_sharded_zero1.py`` runs the
#: third on another worker, with these tests)
NAMES = ("data2_model2_xla", "pod2_model2_psum_compressed", "pod2_model2_compressed_b16")


@pytest.fixture(scope="module")
def names():
    return NAMES


@pytest.fixture(params=NAMES)
def scenario(request):
    return request.param


@pytest.fixture(scope="module")
def ref_params():
    """The reference's llama3.2-1b smoke parameters from PRNGKey(0), numpy."""
    jax = pytest.importorskip("jax")
    from repro.configs import get_smoke_config as ref_config
    from repro.models.registry import build as ref_build

    params = ref_build(ref_config(ARCH)).init(jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def shared():
    with tempfile.TemporaryDirectory() as d:
        yield d


@pytest.fixture(scope="module")
def four_ranks(ref_params, shared, names):
    ranks = spawn("test_torch_sharded_train:_rank_scenarios", 4, backend="gloo",
                  args=(shared, ref_params, names), threads=1, timeout_s=400.0)
    for r, out in enumerate(ranks):
        for key, val in out.items():
            assert not isinstance(val, str), f"rank {r}, {key}:\n{val}"
    return ranks


@pytest.fixture(scope="module")
def reference(names):
    """The reference trainer on each scenario's mesh shape: its losses, and
    each leaf's block shape under its parameter and moment shardings."""
    jax = pytest.importorskip("jax")
    from repro import compat
    from repro.configs import get_smoke_config as ref_config
    from repro.configs.base import TrainConfig as RefTrainConfig
    from repro.data.synthetic import batches_for as ref_batches
    from repro.launch.mesh import make_test_mesh as ref_mesh
    from repro.train.trainer import HostSpec as RefHost
    from repro.train.trainer import ReconfigurableTrainer as RefTrainer

    cfg = ref_config(ARCH)
    tcfg = RefTrainConfig(learning_rate=TCFG.learning_rate, warmup_steps=TCFG.warmup_steps,
                          total_steps=TCFG.total_steps)
    out = {}
    for name in names:
        shape, axes, transports, steps = SCENARIOS[name]
        mesh = ref_mesh(shape, axes)
        # jax.set_mesh scopes the mesh for jit on jax 0.9, over any mesh an
        # earlier test left set process-wide (tests/test_substrate.py does)
        with (jax.set_mesh(mesh) if hasattr(jax, "set_mesh") else compat.use_mesh(mesh)):
            tr = _ref_trainer(RefTrainer, WIRE_BLOCK.get(name))(
                cfg, SHAPE, mesh, tcfg=tcfg, transport=transports[0],
                hosts=[RefHost(0, list(transports) + ["xla"])])
            shapes = tr.model.param_shapes()
            flat = lambda tree: jax.tree_util.tree_flatten_with_path(  # noqa: E731
                tree, is_leaf=lambda x: hasattr(x, "shard_shape"))[0]
            blocks = {kind: {tuple(k.key for k in path): sh.shard_shape(leaf.shape)
                             for (path, sh), (_, leaf) in zip(flat(tree), flat(shapes))}
                      for kind, tree in (("params", tr.state_sh.params),
                                         ("m", tr.state_sh.opt.m))}
            state = tr.init_state(jax.random.PRNGKey(0))
            losses = []
            gen = ref_batches(cfg, SHAPE)
            for t, n in zip(transports, steps):
                if t != tr.transport_name:
                    state = tr.reconfigure(state, t)
                state, hist = tr.run(state, gen, n)
                losses += [float(h["loss"]) for h in hist]
        out[name] = {"losses": losses, "blocks": blocks}
    return out


def _ref_trainer(base, block):
    """The reference trainer class, its int8 wire at ``block`` (None: as
    it is)."""
    if block is None:
        return base
    from repro.comm.chunnels import make_transport

    class Trainer(base):
        def _transport_chunnels(self, name):
            if name != "compressed_int8":
                return super()._transport_chunnels(name)
            return (make_transport(name, axis="pod", block=block),)

    return Trainer


def _ref_block(blocks: dict, name: str) -> tuple:
    """The reference's block shape of the port's parameter ``name``."""
    if name.startswith("layers."):
        _, _, rest = name.split(".", 2)
        return tuple(blocks[("layers",) + tuple(rest.split("."))][1:])
    return tuple(blocks[tuple(name.split("."))])


def test_losses_match_reference_trainer(four_ranks, reference, scenario):
    want = reference[scenario]["losses"]
    for out in four_ranks:
        got = out[scenario]["losses"]
        assert len(got) == len(want) == STEPS
        assert all(math.isfinite(l) for l in got)
        np.testing.assert_allclose(got, want, rtol=RTOL)
        assert got == four_ranks[0][scenario]["losses"]


@pytest.fixture(scope="module")
def one_rank(ref_params):
    """The port's trainer on one rank from the same parameters: its losses
    over the scenarios' steps (``xla``)."""
    cfg = get_smoke_config(ARCH)
    tr = ReconfigurableTrainer(cfg, SHAPE, make_mesh((1,), ("data",), device="cpu"), tcfg=TCFG)
    _, hist = tr.run(tr.init_state(params=ref_params), batches_for(cfg, SHAPE), STEPS)
    return [h["loss"] for h in hist]


def test_losses_match_one_rank_run(four_ranks, one_rank, scenario):
    """The layout changes no result beyond the order of the sums: the steps
    under an exact transport within 1e-4 (relative) of one rank's (2.3e-5 seen)."""
    _, _, transports, steps = SCENARIOS[scenario]
    # the steps before the first lossy (int8) one
    lossy = [i for i, t in enumerate(transports) if t == "compressed_int8"]
    exact = sum(steps[:lossy[0]]) if lossy else STEPS
    for out in four_ranks:
        np.testing.assert_allclose(out[scenario]["losses"][:exact], one_rank[:exact], rtol=1e-4)


def test_blocks_equal_slices_of_gathered_state(four_ranks, scenario):
    for out in four_ranks:
        assert out[scenario]["blocks"] == [True] * STEPS


def test_params_bit_equal_across_pod(four_ranks, names):
    """After every step, the two ranks that differ only in ``pod`` hold
    bit-equal parameter blocks (two pairs in each scenario with a pod
    axis)."""
    pairs = 0
    pod_scenarios = [n for n in names if n.startswith("pod")]
    for scenario in pod_scenarios:
        for a in four_ranks:
            for b in four_ranks:
                ca, cb = a[scenario]["coords"], b[scenario]["coords"]
                if ca["pod"] < cb["pod"] and all(ca[k] == cb[k] for k in ca if k != "pod"):
                    assert a[scenario]["checksums"] == b[scenario]["checksums"]
                    pairs += 1
    assert pairs == 2 * len(pod_scenarios)


def test_blocks_have_reference_shard_shapes(four_ranks, reference, scenario):
    """Parameter blocks as the reference's parameter shardings give them,
    moment blocks as its ZeRO-1 moment shardings."""
    blocks = reference[scenario]["blocks"]
    for out in four_ranks:
        for name, shape in out[scenario]["param_shapes"].items():
            assert shape == _ref_block(blocks["params"], name), name
        for name, shape in out[scenario]["moment_shapes"].items():
            assert shape == _ref_block(blocks["m"], name), name
    if scenario == "pod2_data2_psum":  # ZeRO-1: the moments are split further
        out = four_ranks[0][scenario]
        assert out["moment_shapes"]["layers.0.mlp.up.w"][0] * 2 == \
            out["param_shapes"]["layers.0.mlp.up.w"][0]


def test_switch_is_committed_on_every_rank(four_ranks):
    for out in four_ranks:
        rec = out["pod2_model2_psum_compressed"]
        assert rec["transport"] == "compressed_int8"
        assert rec["log"] == [{"from": "psum", "to": "compressed_int8", "committed": True,
                               "at_step": STEPS // 2}]


def test_checkpoint_restores_onto_another_sharding(four_ranks):
    """(data 2, model 2)'s checkpoint, restored on (pod 2, model 2): the
    gathered leaves equal the saved ones exactly, every block its slice."""
    saved_p, saved_m = four_ranks[0]["data2_model2_xla"]["saved"]
    for out in four_ranks:
        at, params, moments, blocks_ok = out["pod2_model2_psum_compressed"]["restored"]
        assert at == STEPS and blocks_ok
        assert params.keys() == saved_p.keys() and moments.keys() == saved_m.keys()
        for n in params:
            np.testing.assert_array_equal(params[n], saved_p[n])
            np.testing.assert_array_equal(moments[n], saved_m[n])


def test_checkpoint_restores_on_one_rank(four_ranks, shared):
    """The same checkpoint restored by a one-rank trainer in this process."""
    tr = ReconfigurableTrainer(get_smoke_config(ARCH), SHAPE,
                               make_mesh((1,), ("data",), device="cpu"), tcfg=TCFG,
                               ckpt_dir=str(Path(shared) / "data2_model2_xla"))
    state, at = tr.restore()
    saved_p, saved_m = four_ranks[0]["data2_model2_xla"]["saved"]
    assert at == STEPS and state.step == STEPS
    for n, p in state.params.items():
        np.testing.assert_array_equal(p.detach().numpy(), saved_p[n])
        np.testing.assert_array_equal(state.opt.m[n].float().numpy(), saved_m[n])


def test_restore_with_resharding(four_ranks):
    """The reference's ``TestCheckpoint.test_restore_with_resharding`` on
    (data 2, model 2): each rank holds the rows of its ``data`` block."""
    full = np.arange(16.0).reshape(4, 4)
    for rank, out in enumerate(four_ranks):
        d = rank // 2  # (data 2, model 2), row-major
        np.testing.assert_array_equal(np.asarray(out["resharding"]), full[2 * d:2 * d + 2])


def test_block_16_wire_runs_on_own_shards(four_ranks):
    """The block-16 scenario's wire is at block 16, and every leaf of the
    smoke model is own under it on every rank: no leaf is gathered."""
    for out in four_ranks:
        rec = out["pod2_model2_compressed_b16"]
        assert rec["wire_blocks"] == [16]
        assert len(rec["own"]) == 11 and all(rec["own"])
