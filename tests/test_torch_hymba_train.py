"""The hybrid family's training loss (hymba) held to the jitted reference.

``HymbaLM`` subclasses ``DenseLM``; before it had a training forward of its
own, ``HymbaLM.loss`` ran the dense layer body (no SSM branch, no fusion,
the sliding window on the global layers too) and returned a wrong loss with
no gradient for any ``ssm.*`` or ``gn_*`` parameter. On ``hymba-smoke``, with
the reference's parameters carried across:

- the loss within 1e-3 (relative) of the jitted ``hymba.loss_fn`` and every
  parameter's gradient set (the repaired fault);
- each leaf's gradient, with ``attn_impl`` ``xla_dense`` and ``xla_chunked``:
  its relative L2 distance within 4e-2, and its largest difference within
  6e-2 of the leaf's largest |g|. Both sides multiply in bfloat16, through
  two normalised branches and the scan, so the dense family's 2e-2 of the
  largest |g| (``test_torch_train.py``) is below either side's own
  rounding: against a run of the port with float32 products, on this batch,
  the port's leaves are 0.8-3.1e-2 away in L2 (up to 4.2e-2 of the largest
  |g|) and the reference's 0.9-3.7e-2 (up to 5.9e-2); the port and the
  reference are 0.7-3.5e-2 apart (up to 4.2e-2);
- training goes through the plain scan whatever ``ssm_impl`` (serving's
  Select) says: the scan kernel has no backward;
- 10 one-rank trainer steps within 2e-2 (relative) of the reference
  trainer's losses.
"""
import os

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import math

import numpy as np
import pytest
import torch

from repro_torch import tree as T
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import ShapeConfig, TrainConfig
from repro_torch.data.synthetic import batches_for
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import ssm
from repro_torch.models.convert import params_from_reference
from repro_torch.models.stacking import stack_layers
from repro_torch.train.trainer import ReconfigurableTrainer

ARCH = "hymba-1.5b"
SHAPE = ShapeConfig("t", 64, 4, "train")
TCFG = TrainConfig(learning_rate=1e-3, warmup_steps=2, total_steps=50)


@pytest.fixture(scope="module")
def ref_params():
    """The reference's hymba smoke parameters from PRNGKey(0), numpy."""
    jax = pytest.importorskip("jax")
    from repro.configs import get_smoke_config as ref_config
    from repro.models.registry import build as ref_build

    params = ref_build(ref_config(ARCH)).init(jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, params)


def _batch(vocab: int) -> dict:
    rng = np.random.default_rng(0)
    toks = rng.integers(0, vocab, (4, 65)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


_REF: dict = {}


def _reference(ref_params, impl: str, batch: dict):
    """The jitted reference's loss and gradients (computed once per impl)."""
    if impl not in _REF:
        jax = pytest.importorskip("jax")
        from repro.configs import get_smoke_config as ref_config
        from repro.models.registry import build as ref_build

        model = ref_build(ref_config(ARCH).replace(attn_impl=impl))
        _REF[impl] = jax.jit(jax.value_and_grad(model.loss))(ref_params, batch)
    return _REF[impl]


def _port(ref_params, impl: str, batch: dict):
    cfg = get_smoke_config(ARCH).replace(attn_impl=impl)
    model = params_from_reference(ref_params, cfg, device="cpu").release()
    loss = model.loss({k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    return model, loss


def test_loss_is_the_hybrid_models(ref_params):
    """The fault: the loss is hymba's (both branches, fused, the window by
    segment), and every parameter, the SSM's and the fusion norms' too, has
    a gradient."""
    batch = _batch(get_smoke_config(ARCH).vocab_size)
    loss_ref, _ = _reference(ref_params, "xla_dense", batch)
    model, loss = _port(ref_params, "xla_dense", batch)
    assert abs(loss.item() - float(loss_ref)) <= 1e-3 * abs(float(loss_ref))
    for name, p in model.named_parameters():
        assert p.grad is not None and p.grad.abs().max() > 0, name
    assert any(".ssm." in n for n, _ in model.named_parameters())


@pytest.mark.parametrize("impl", ["xla_dense", "xla_chunked"])
def test_loss_and_grads_match_jitted_reference(ref_params, impl):
    jax = pytest.importorskip("jax")
    batch = _batch(get_smoke_config(ARCH).vocab_size)
    loss_ref, g_ref = _reference(ref_params, impl, batch)
    model, loss = _port(ref_params, impl, batch)
    assert abs(loss.item() - float(loss_ref)) <= 1e-3 * abs(float(loss_ref))
    grads = stack_layers({n: p.grad for n, p in model.named_parameters()}, model.stacks())
    got, want = T.flatten_with_paths(grads), jax.tree_util.tree_flatten_with_path(g_ref)[0]
    assert len(got) == len(want) == 23
    for (path, g), (ref_path, w) in zip(got, want):
        assert path == tuple(k.key for k in ref_path)
        w, g = np.asarray(w), g.numpy()
        assert g.shape == w.shape
        assert np.linalg.norm(g - w) <= 4e-2 * np.linalg.norm(w), path
        assert np.abs(g - w).max() <= 6e-2 * np.abs(w).max(), path


def test_training_never_reaches_the_scan_select(ref_params, monkeypatch):
    """With serving's Select on the kernel (``ssm_impl = "pallas"``, the
    default), the training forward still scans with the plain version."""
    def refuse(*args):
        raise AssertionError("the training forward reached the scan Select")

    monkeypatch.setitem(ssm.SCANS, "pallas", refuse)
    cfg = get_smoke_config(ARCH)
    model = params_from_reference(ref_params, cfg, device="cpu").release()
    assert model.ssm_impl == "pallas"
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg.vocab_size).items()}
    model.loss(batch).backward()
    with pytest.raises(AssertionError, match="reached the scan Select"):
        model.prefill(batch["tokens"])


def test_trainer_matches_reference_trainer(ref_params):
    """10 one-rank steps (``xla``) from the reference's parameters, against
    the reference trainer on a (1, 1) mesh: within 2e-2 relative."""
    jax = pytest.importorskip("jax")
    from repro import compat
    from repro.configs import get_smoke_config as ref_config
    from repro.configs.base import TrainConfig as RefTrainConfig
    from repro.data.synthetic import batches_for as ref_batches
    from repro.launch.mesh import make_test_mesh as ref_mesh
    from repro.train.trainer import ReconfigurableTrainer as RefTrainer

    mesh = ref_mesh((1, 1))
    # jax.set_mesh scopes the mesh for jit on jax 0.9, over any mesh an
    # earlier test left set process-wide (tests/test_substrate.py does)
    with (jax.set_mesh(mesh) if hasattr(jax, "set_mesh") else compat.use_mesh(mesh)):
        tcfg = RefTrainConfig(learning_rate=TCFG.learning_rate, warmup_steps=TCFG.warmup_steps,
                              total_steps=TCFG.total_steps)
        ref = RefTrainer(ref_config(ARCH), SHAPE, mesh, tcfg=tcfg)
        _, hist = ref.run(ref.init_state(jax.random.PRNGKey(0)),
                          ref_batches(ref_config(ARCH), SHAPE), 10)
        want = [float(h["loss"]) for h in hist]
    cfg = get_smoke_config(ARCH)
    tr = ReconfigurableTrainer(cfg, SHAPE, make_mesh((1,), ("data",), device="cpu"), tcfg=TCFG)
    _, hist = tr.run(tr.init_state(params=ref_params), batches_for(cfg, SHAPE), 10)
    got = [h["loss"] for h in hist]
    assert all(math.isfinite(l) for l in got)
    np.testing.assert_allclose(got, want, rtol=2e-2)
