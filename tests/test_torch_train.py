"""The port's trainer substrate held against the reference.

In this process, each against the jitted reference with the same inputs:

- the dense smoke config's loss and gradients (llama3.2-1b smoke, the
  reference's parameters carried across): the loss within 1e-3 relative;
  each leaf's gradient within 2e-2 of its largest |g|, because both sides
  multiply in bfloat16 and round at other places (each is about 2e-2 from a
  float32 run of the same model); with the published config's chunked
  attention, 3e-2 (more bf16 rounding on both sides);
- one AdamW update: parameters within 1e-6 relative, moments (bfloat16)
  equal, the learning rate and the gradient norm within 1e-6;
- the synthetic data: bit-equal;
- the reference's own ``TestData``, ``TestCheckpoint`` (but
  ``test_restore_with_resharding``, which needs a (data 2, model 4) mesh: its
  counterpart runs on four ranks in ``test_torch_sharded_train.py``) and
  ``TestTrainerDefaultPolicy``, mirrored onto the port
  (``tests/port_mirror.py``);
- the one-rank launcher with each of the seven transports, and a restart
  from a checkpoint that gives the uninterrupted run's losses exactly.

On two ranks (one ``spawn`` of two processes, ``gloo`` on the CPU, a mesh of
``pod`` 2), each running the same code:

- the reference's ``TestTrainer``, ``TestTrainerControllerPlane`` and the
  flow of ``test_system.py`` (negotiate, 10 steps of psum, reconfigure to
  compressed, 10 steps, save, restore, 5 steps, the loss falls), mirrored,
  with the ``model`` axis of their meshes cut to 1 rank (two processes, not
  eight; ``test_torch_sharded_train.py`` runs the sharded layouts); every rank
  must pass each;
- the first 10 losses of the trainer with psum and with compressed_int8,
  from the reference's parameters, against the reference trainer on a
  ``pod`` = 2 mesh: within 2e-2 relative (the gradients' bfloat16 rounding,
  above, carried through 10 updates);
- the launcher's rank path with each of the seven transports: finite
  losses, the same on both ranks, the negotiated transport the one asked.

And the launcher's own spawn of two ranks, once.
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

from port_mirror import mirror
from repro_torch import tree as T
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import ShapeConfig, TrainConfig
from repro_torch.data.synthetic import DataConfig, SyntheticLM, batches_for
from repro_torch.launch import train as launch_train
from repro_torch.launch.mesh import make_mesh, make_test_mesh, spawn
from repro_torch.models.convert import params_from_reference
from repro_torch.models.stacking import stack_layers
from repro_torch.optim import adamw
from repro_torch.train.trainer import HostSpec, ReconfigurableTrainer

TRANSPORTS = ("xla", "psum", "ring", "hierarchical", "compressed_int8", "hier_compressed",
              "localsgd")
#: the trainer's cases: the reference's smoke config and shape
ARCH = "llama3.2-1b"
SHAPE = ShapeConfig("t", 64, 4, "train")
TCFG = TrainConfig(learning_rate=1e-3, warmup_steps=2, total_steps=50)
COMPARED = ("psum", "compressed_int8")

_JAX_IMPORTS = ("import jax\nimport jax.numpy as jnp\nimport numpy as np\nimport pytest\n"
                "from repro import compat\n",
                "import numpy as np\nimport pytest\nfrom port_mirror import compat, jax, jnp\n")
_SUB = mirror("test_substrate.py", ["TestData", "TestCheckpoint", "TestTrainer"], edits=[
    _JAX_IMPORTS,
    ('m = make_test_mesh((2, 4), ("pod", "model"))',
     'm = make_test_mesh((2, 1), ("pod", "model"), device="cpu")'),
    ("np.asarray(a), np.asarray(b)", "np.asarray(a.float()), np.asarray(b.float())")])
# needs a (data 2, model 4) mesh; test_torch_sharded_train.py runs its counterpart
del _SUB["TestCheckpoint"].test_restore_with_resharding
TestData = _SUB["TestData"]
TestCheckpoint = _SUB["TestCheckpoint"]
_CTL = mirror("test_controller.py", ["TestTrainerControllerPlane"], edits=[
    ("import jax\n        from repro import compat", "from port_mirror import compat, jax"),
    ("from repro import compat", "from port_mirror import compat"),
    ('make_test_mesh((2, 1), ("pod", "model"))',
     'make_test_mesh((2, 1), ("pod", "model"), device="cpu")')])
TestTrainerDefaultPolicy = mirror("test_policy.py", ["TestTrainerDefaultPolicy"])[
    "TestTrainerDefaultPolicy"]
_SYS = mirror("test_system.py", ["test_end_to_end_train_reconfigure_restore"], edits=[
    ("import jax\nimport numpy as np\nfrom repro import compat\n",
     "import numpy as np\nfrom port_mirror import compat, jax\n"),
    ('mesh = make_test_mesh((2, 4), ("pod", "model"))',
     'mesh = make_test_mesh((2, 1), ("pod", "model"), device="cpu")')])

#: the reference scenarios every rank runs: name -> (class or None, method)
RANK_SCENARIOS = {
    **{f"TestTrainer.{n}": (_SUB["TestTrainer"], n)
       for n in dir(_SUB["TestTrainer"]) if n.startswith("test_")},
    **{f"TestTrainerControllerPlane.{n}": (_CTL["TestTrainerControllerPlane"], n)
       for n in dir(_CTL["TestTrainerControllerPlane"]) if n.startswith("test_")},
    "test_system.test_end_to_end_train_reconfigure_restore":
        (None, "test_end_to_end_train_reconfigure_restore"),
}


def _run_scenario(key, shared: Path, pod_mesh):
    cls, name = RANK_SCENARIOS[key]
    tmp = shared / key.replace(".", "_")
    if cls is None:
        return _SYS[name](tmp)
    fn = getattr(cls(), name)
    args = fn.__code__.co_varnames[1:fn.__code__.co_argcount]
    return fn(*[{"pod_mesh": pod_mesh, "tmp_path": tmp}[a] for a in args])


def _rank_scenarios(shared: str, ref_params: dict) -> dict:
    """Every two-rank case on this rank (spawn target): "ok" or the
    traceback of each reference scenario, the compared runs' losses, and
    each transport's launcher run."""
    out = {}
    pod_mesh = make_test_mesh((2, 1), ("pod", "model"), device="cpu")
    for key in RANK_SCENARIOS:
        try:
            _run_scenario(key, Path(shared), pod_mesh)
            out[key] = "ok"
        except Exception:
            out[key] = traceback.format_exc()
    cfg = get_smoke_config(ARCH)
    for t in COMPARED:
        tr = ReconfigurableTrainer(cfg, SHAPE, pod_mesh, tcfg=TCFG, transport=t,
                                   hosts=[HostSpec(0, [t, "xla"])])
        _, hist = tr.run(tr.init_state(params=ref_params), batches_for(cfg, SHAPE), 10)
        out[f"losses {t}"] = [h["loss"] for h in hist]
    for t in TRANSPORTS:
        run = launch_train._rank(["--smoke", "--device", "cpu", "--world", "2", "--transport",
                                  t, "--steps", "3"], "gloo")
        out[f"launch {t}"] = (run["transport"], run["losses"])
    return out


@pytest.fixture(scope="module")
def ref_params():
    """The reference's llama3.2-1b smoke parameters from PRNGKey(0), numpy."""
    jax = pytest.importorskip("jax")
    from repro.configs import get_smoke_config as ref_config
    from repro.models.registry import build as ref_build

    params = ref_build(ref_config(ARCH)).init(jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def two_ranks(ref_params):
    with tempfile.TemporaryDirectory() as shared:
        yield spawn("test_torch_train:_rank_scenarios", 2, backend="gloo", threads=1,
                    args=(shared, ref_params), timeout_s=300.0)


@pytest.fixture(scope="module")
def ref_losses():
    """The reference trainer's first 10 losses on a pod = 2 mesh, per
    compared transport; the mesh is scoped, so none leaks to later tests."""
    jax = pytest.importorskip("jax")
    from repro import compat
    from repro.configs import get_smoke_config as ref_config
    from repro.configs.base import TrainConfig as RefTrainConfig
    from repro.data.synthetic import batches_for as ref_batches
    from repro.launch.mesh import make_test_mesh as ref_mesh
    from repro.train.trainer import HostSpec as RefHost
    from repro.train.trainer import ReconfigurableTrainer as RefTrainer

    cfg = ref_config(ARCH)
    mesh = ref_mesh((2, 1), ("pod", "model"))
    out = {}
    with compat.use_mesh(mesh):
        for t in COMPARED:
            tcfg = RefTrainConfig(learning_rate=TCFG.learning_rate,
                                  warmup_steps=TCFG.warmup_steps, total_steps=TCFG.total_steps)
            tr = RefTrainer(cfg, SHAPE, mesh, tcfg=tcfg, transport=t,
                            hosts=[RefHost(0, [t, "xla"])])
            _, hist = tr.run(tr.init_state(jax.random.PRNGKey(0)), ref_batches(cfg, SHAPE), 10)
            out[t] = [float(h["loss"]) for h in hist]
    return out


# -- the reference's scenarios on two ranks -------------------------------------


def _scenario_test(key):
    def test(self, two_ranks):
        for rank, out in enumerate(two_ranks):
            assert out[key] == "ok", f"rank {rank}:\n{out[key]}"
    test.__name__ = key.split(".")[1]
    test.__doc__ = f"The reference's {key}, on every rank of a pod = 2 mesh."
    return test


class TestTrainer:
    """The reference's ``TestTrainer`` (tests/test_substrate.py) on two ranks."""


class TestTrainerControllerPlane:
    """The reference's ``TestTrainerControllerPlane`` (tests/test_controller.py)
    on two ranks."""


class TestSystem:
    """The flow of the reference's tests/test_system.py on two ranks."""


for _key in RANK_SCENARIOS:
    _cls = {"TestTrainer": TestTrainer, "TestTrainerControllerPlane": TestTrainerControllerPlane,
            "test_system": TestSystem}[_key.split(".")[0]]
    setattr(_cls, _key.split(".")[1], _scenario_test(_key))


@pytest.mark.parametrize("transport", COMPARED)
def test_two_rank_losses_match_reference_trainer(two_ranks, ref_losses, transport):
    want = ref_losses[transport]
    for out in two_ranks:
        got = out[f"losses {transport}"]
        assert len(got) == len(want) == 10
        np.testing.assert_allclose(got, want, rtol=2e-2)
    assert two_ranks[0][f"losses {transport}"] == two_ranks[1][f"losses {transport}"]


@pytest.mark.parametrize("transport", TRANSPORTS)
def test_launcher_rank_path_each_transport(two_ranks, transport):
    got = [out[f"launch {transport}"] for out in two_ranks]
    assert got[0] == got[1]
    name, losses = got[0]
    assert name == transport and len(losses) == 3
    assert all(math.isfinite(l) for l in losses)


def test_launcher_spawns_two_ranks(tmp_path, capfd):
    run = launch_train.main(["--smoke", "--device", "cpu", "--world", "2", "--threads", "1",
                             "--backend", "gloo",
                             "--transport", "compressed_int8", "--steps", "3",
                             "--ckpt", str(tmp_path), "--ckpt-every", "2"])
    assert run.world == 2 and run.backend == "gloo" and run.transport == "compressed_int8"
    assert len(run.losses) == 3 and all(math.isfinite(l) for l in run.losses)
    assert (tmp_path / "LATEST").read_text() == "2"
    assert "torch.distributed: backend gloo, world 2" in capfd.readouterr().out


# -- one rank, in this process -------------------------------------------------------


@pytest.mark.parametrize("transport", TRANSPORTS)
def test_launcher_one_rank_each_transport(transport):
    run = launch_train.main(["--smoke", "--device", "cpu", "--transport", transport,
                             "--steps", "3"])
    assert run.world == 1 and len(run.losses) == 3
    assert all(math.isfinite(l) for l in run.losses)


def test_restart_from_checkpoint_repeats_the_losses(tmp_path):
    """Steps 4-7 after restoring the step-4 checkpoint equal the
    uninterrupted run's, bit for bit (the data is deterministic)."""
    argv = ["--smoke", "--device", "cpu", "--steps", "8", "--ckpt", str(tmp_path),
            "--ckpt-every", "4"]
    full = launch_train.main(argv)
    args = launch_train.parse(argv)
    tr = launch_train.build(args, make_mesh((1,), ("data",), device="cpu"))
    state, at = tr.restore(step=4)
    assert at == 4 and state.step == 4 and state.opt.count == 4
    _, hist = tr.run(state, batches_for(tr.cfg, tr.shape), 4)
    assert [h["loss"] for h in hist] == full.losses[4:]


# -- against the reference, in this process ---------------------------------------


@pytest.mark.parametrize("impl,chunk,tol", [("xla_dense", 1024, 2e-2), ("xla_chunked", 16, 3e-2),
                                            ("xla_chunked", 1024, 3e-2)])
def test_dense_loss_and_grads_match_jitted_reference(ref_params, impl, chunk, tol):
    """The smoke config attends with ``xla_dense``; the published one with
    ``xla_chunked``, here in chunks of 16 of the 64 positions and in one
    chunk of 1024 padded past them (as the published chunk pads a sequence
    of 128). Gradients within ``tol`` of each leaf's largest |g|: 2e-2 for
    the bf16 products; 3e-2 where the chunked attention also rounds its
    scores and softmax weights to bf16 on both sides (each side is 1.5-2.7e-2
    from a float32 run of the port then)."""
    jax = pytest.importorskip("jax")
    from repro.configs import get_smoke_config as ref_config
    from repro.models.registry import build as ref_build

    ref_model = ref_build(ref_config(ARCH).replace(attn_impl=impl, attn_chunk=chunk))
    rng = np.random.default_rng(0)
    toks = rng.integers(0, ref_model.cfg.vocab_size, (4, 65)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    loss_ref, g_ref = jax.jit(jax.value_and_grad(ref_model.loss))(ref_params, batch)

    cfg = get_smoke_config(ARCH).replace(attn_impl=impl, attn_chunk=chunk)
    model = params_from_reference(ref_params, cfg, device="cpu").release()
    loss = model.loss({k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    assert abs(loss.item() - float(loss_ref)) <= 1e-3 * abs(float(loss_ref))
    grads = stack_layers({n: p.grad for n, p in model.named_parameters()}, model.stacks())
    got, want = T.flatten_with_paths(grads), jax.tree_util.tree_flatten_with_path(g_ref)[0]
    assert len(got) == len(want) == 11
    for (path, g), (ref_path, w) in zip(got, want):
        assert path == tuple(k.key for k in ref_path)
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape
        assert np.abs(g.numpy() - w).max() <= tol * np.abs(w).max(), path


def test_serving_copies_block_training():
    """A model with its serving copies refuses to train; released, every
    float32 parameter gets a gradient."""
    from repro_torch.models.registry import build

    m = build(get_smoke_config(ARCH), device="cpu", seed=0)
    batch = {"tokens": torch.zeros(1, 8, dtype=torch.int32),
             "labels": torch.zeros(1, 8, dtype=torch.int32)}
    with pytest.raises(RuntimeError, match="release"):
        m.loss(batch)
    m.release().loss(batch).backward()
    assert all(p.grad is not None for p in m.parameters())


@pytest.mark.parametrize("clip", [1.0, 0.0, 100.0])
def test_adamw_update_matches_jitted_reference(clip):
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.configs.base import TrainConfig as RefTrainConfig
    from repro.optim import adamw as ref

    rng = np.random.default_rng(3)
    shapes = {"embed": {"table": (64, 16)}, "layers": {"scale": (2, 16), "w": (2, 16, 16)},
              "final": (16,)}

    def draw(scale, fn=lambda a: a):
        return jax.tree.map(lambda s: fn(rng.standard_normal(s) * scale).astype(np.float32),
                            shapes, is_leaf=lambda x: isinstance(x, tuple))

    params, grads = draw(0.5), draw(2.0)
    bf16 = lambda t: jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32), t)
    m, v = bf16(draw(0.1)), bf16(draw(0.1, np.abs))
    kw = dict(grad_clip=clip, learning_rate=1e-2, weight_decay=0.1)
    rcfg, pcfg = RefTrainConfig(**kw), TrainConfig(**kw)
    lr = float(ref.lr_schedule(rcfg)(jnp.asarray(37)))
    assert abs(adamw.lr_schedule(pcfg)(37) - lr) <= 1e-6 * lr
    as16 = lambda t: jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), t)
    state = ref.AdamWState(m=as16(m), v=as16(v), count=jnp.asarray(3, jnp.int32))
    p_ref, s_ref, met_ref = jax.jit(lambda g, s, p: ref.update(g, s, p, lr, rcfg))(
        grads, state, params)

    t32 = lambda t: T.map(lambda a: torch.from_numpy(np.array(a, np.float32)), t)
    t16 = lambda t: T.map(lambda a: torch.from_numpy(np.array(a, np.float32)).to(torch.bfloat16), t)
    p, s, met = adamw.update(t32(grads), adamw.AdamWState(t16(m), t16(v), 3), t32(params), lr,
                             pcfg)
    assert s.count == int(s_ref.count) == 4
    for a, b in zip(T.leaves(p), jax.tree.leaves(p_ref)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=0)
    for a, b in zip(T.leaves((s.m, s.v)), jax.tree.leaves((s_ref.m, s_ref.v))):
        assert a.dtype == torch.bfloat16
        np.testing.assert_array_equal(a.float().numpy(), np.asarray(b, np.float32))
    assert abs(met["grad_norm"].item() - float(met_ref["grad_norm"])) <= 1e-6 * float(
        met_ref["grad_norm"])


@pytest.mark.parametrize("transport", ["compressed_int8", "localsgd"])
def test_transport_state_has_the_reference_layout(transport):
    """The chunnel state a trainer starts with, on a mesh with a ``pod``
    axis: the error feedback's residuals are the reference's stacked leaves
    (11, in its leaf order), the localsgd counter its one leaf."""
    jax = pytest.importorskip("jax")
    from repro import compat
    from repro.configs import get_smoke_config as ref_config
    from repro.launch.mesh import make_test_mesh as ref_mesh
    from repro.train.trainer import HostSpec as RefHost
    from repro.train.trainer import ReconfigurableTrainer as RefTrainer

    mesh = ref_mesh((1, 1), ("pod", "data"))
    with compat.use_mesh(mesh):
        ref = RefTrainer(ref_config(ARCH), SHAPE, mesh, transport=transport,
                         hosts=[RefHost(0, [transport])])
        want = jax.tree_util.tree_flatten_with_path(ref.init_state(jax.random.PRNGKey(0)).comm)[0]
    tr = ReconfigurableTrainer(get_smoke_config(ARCH), SHAPE,
                               make_mesh((1, 1), ("pod", "data"), device="cpu"),
                               transport=transport, hosts=[HostSpec(0, [transport])])
    got = T.flatten_with_paths(tr.init_state(0).comm)
    assert len(got) == len(want) == (11 if transport == "compressed_int8" else 1)
    for (path, g), (ref_path, w) in zip(got, want):
        assert path == tuple(getattr(k, "key", getattr(k, "idx", None)) for k in ref_path)
        assert tuple(np.shape(g)) == tuple(w.shape)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_batch_specs_match_reference(kind):
    """Every family's batch shapes and dtypes, as the reference's
    ``Model.batch_specs`` (the vlm batch's ``patches`` and the audio batch's
    ``frames`` outside decode)."""
    pytest.importorskip("jax")
    from repro.configs import get_smoke_config as ref_config
    from repro.models.registry import build as ref_build
    from repro_torch.models import registry

    shape = ShapeConfig("s", 32, 4, kind)
    archs = (ARCH, "hymba-1.5b", "phi-3-vision-4.2b", "qwen3-moe-235b-a22b", "xlstm-125m",
             "seamless-m4t-medium")
    assert {get_smoke_config(a).family for a in archs} == {
        "dense", "hybrid", "vlm", "moe", "ssm", "audio"}
    for arch in archs:
        want = ref_build(ref_config(arch)).batch_specs(shape)
        got = registry.batch_specs(get_smoke_config(arch), shape)
        assert {k: (tuple(v.shape), str(v.dtype)) for k, v in want.items()} == {
            k: (shp, str(dt).removeprefix("torch.")) for k, (shp, dt) in got.items()}


@pytest.mark.parametrize("host", [(0, 1), (0, 2), (1, 2), (3, 4)])
@pytest.mark.parametrize("vocab,seq", [(256, 64), (128256, 128), (50, 16)])
def test_synthetic_data_bit_equal_to_reference(host, vocab, seq):
    from repro.data import synthetic as ref

    cfg = dict(vocab_size=vocab, seq_len=seq, global_batch=8)
    got = SyntheticLM(DataConfig(**cfg), host_id=host[0], num_hosts=host[1])
    want = ref.SyntheticLM(ref.DataConfig(**cfg), host_id=host[0], num_hosts=host[1])
    for step in (0, 5):
        a, b = got.batch(step), want.batch(step)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("walk", ["flatten_with_paths", "leaves", "map"])
def test_tree_walks_leave_no_reference_cycle(walk):
    """The port's tree helpers free what they walked as soon as their
    results go: a reference cycle (a nested recursive closure) would keep
    the leaves, a step's whole gradient, until the cyclic collector runs."""
    import gc
    import weakref

    leaf = torch.ones(4)
    tree = {"a": [leaf, torch.zeros(2)], "b": (torch.zeros(1),)}
    ref = weakref.ref(leaf)
    enabled = gc.isenabled()
    gc.disable()
    try:
        out = {"flatten_with_paths": lambda: T.flatten_with_paths(tree),
               "leaves": lambda: T.leaves(tree),
               "map": lambda: T.map(lambda x: x, tree)}[walk]()
        del out, tree, leaf
        assert ref() is None
    finally:
        if enabled:
            gc.enable()


def test_steps_keep_no_gradients_alive(monkeypatch):
    """After training, no step's gradients are alive, even with the cyclic
    collector off: a step's frames may outlive it (the first step's are held
    through a lazy import in its checkpointed forward), so the step must not
    keep its gradients in them."""
    import gc
    import weakref

    from repro_torch.train import step as step_mod

    refs: list = []
    update = adamw.update

    def recording(grads, *args, **kwargs):
        refs.append([weakref.ref(g) for g in T.leaves(grads)])
        return update(grads, *args, **kwargs)

    monkeypatch.setattr(step_mod.adamw, "update", recording)
    enabled = gc.isenabled()
    gc.disable()
    try:
        launch_train.main(["--smoke", "--device", "cpu", "--steps", "3", "--batch", "4",
                           "--seq", "16", "--transport", "xla"])
        assert len(refs) == 3
        assert [sum(r() is not None for r in step) for step in refs] == [0, 0, 0]
    finally:
        if enabled:
            gc.enable()
