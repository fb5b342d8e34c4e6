"""The vlm, moe, ssm and audio families' training losses held to the jitted
reference.

For each of phi-3-vision (vlm), qwen3-moe (moe), xlstm (ssm) and seamless
(audio), at the reference's smoke config with its parameters
(``PRNGKey(0)``) carried across, on one batch of 4 rows of 24 positions
(the vlm batch's 8 patch positions over the first 8, the audio batch's 6
frames):

- the loss within 1e-3 (relative) of the jitted reference ``loss_fn``, and
  every parameter's gradient set;
- each leaf's gradient against ``jax.grad`` of the reference: relative L2
  within 4e-2, largest difference within 6e-2 of the leaf's largest |g|,
  ``tests/test_torch_hymba_train.py``'s bounds (each side multiplies in
  bfloat16: its own rounding against float32 products is of that order).
  For moe, ``jax.grad`` of the reference run op by op (its layers unrolled,
  no remat, not jitted): the jitted reference's fused rounding routes one
  token of layer 0 to another expert than the op-by-op reference does and
  orders three tokens' two experts otherwise, which moves its own gradient
  by up to 12.8% (relative L2) from the op-by-op one's. The port's expert
  sets are the op-by-op reference's in every layer, and its gradient is
  within 1.3% of it;
- 10 one-rank trainer steps within 2e-2 (relative) of the reference
  trainer's losses;
- on four gloo ranks, (data 2, model 2) with FSDP (the parameters laid out
  by the reference's specs: xlstm's unstacked layers, seamless's two
  stacks, phi-3-vision's patches dealt with the rows), the loss averaged
  over ``data`` within 1e-3 of the one-rank port's and the logical
  gradient within the bounds above of it;
- the flat gradient is ``jax.flatten_util.ravel_pytree``'s, leaf by leaf
  (``stacking.stack_layers`` over the model's ``stacks()``: xlstm's list of
  unlike layers, seamless's two stacks, the moe layers' expert banks), so
  that the int8 wire's blocks are the reference's; the compressed
  transport's state has the reference's leaves.

And for the families' own semantics:

- moe: the port's and the op-by-op reference's top-k expert ids, token by
  token, in every layer: the same two experts for every token, in the same
  slot order but for near-ties. In layer 1, 2 of the 96 tokens take their
  two experts in the other order, where the reference's two gate values
  are 0.34% and 0.25% apart: the layer's input differs by a bfloat16 step
  (JAX's silu on bfloat16 rounds otherwise than torch's in 39% of the
  expert SwiGLU's elements). The order feeds the aux loss (slot 0's
  experts) and the capacity priority; a token routed to other experts
  would move the gradients by whole experts, a fault. And the aux's share
  of the loss against the reference's ``moe.hidden_states``;
- vlm: the patches need S >= P. The reference's ``x[:, P:]`` leaves P
  positions against S labels at S < P, and its rope fails to broadcast
  (``ValueError``); the port raises a ``ValueError`` that says so. At S = P
  both train on the patches alone.
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
from repro_torch.models import moe as tmoe
from repro_torch.models import registry
from repro_torch.models.convert import params_from_reference
from repro_torch.models.stacking import stack_layers
from repro_torch.train.trainer import HostSpec, ReconfigurableTrainer

ARCHS = {"vlm": "phi-3-vision-4.2b", "moe": "qwen3-moe-235b-a22b", "ssm": "xlstm-125m",
         "audio": "seamless-m4t-medium"}
B, S = 4, 24
SHAPE = ShapeConfig("t", S, B, "train")
TCFG = TrainConfig(learning_rate=1e-3, warmup_steps=2, total_steps=50)
#: a leaf's gradient against the reference's: relative L2, and the largest
#: difference relative to the leaf's largest |g|
GRAD_L2, GRAD_MAX = 4e-2, 6e-2
#: the reference's leaves (``jax.tree.leaves`` of the parameters), by family
LEAVES = {"vlm": 12, "moe": 13, "ssm": 27, "audio": 35}
#: moe: two experts of a token in the other slot order than the
#: reference's, where its two gate values are this close (relative)
NEAR_TIE = 1e-2


@pytest.fixture(scope="module")
def jax():
    return pytest.importorskip("jax")


_PARAMS: dict = {}


def ref_params(jax, arch: str):
    """The reference's smoke parameters of ``arch`` from PRNGKey(0), numpy."""
    if arch not in _PARAMS:
        from repro.configs import get_smoke_config as ref_config
        from repro.models.registry import build as ref_build

        params = ref_build(ref_config(arch)).init(jax.random.PRNGKey(0))
        _PARAMS[arch] = jax.tree.map(np.asarray, params)
    return _PARAMS[arch]


def _batch(arch: str, seq: int = S) -> dict:
    """Tokens and labels from a seeded generator, with the family's frontend
    arrays (``data.synthetic.frontend_stub``'s)."""
    from repro_torch.data.synthetic import frontend_stub

    cfg = get_smoke_config(arch)
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, seq + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    batch.update(frontend_stub(cfg, ShapeConfig("t", seq, B, "train"), 0))
    return batch


_REF: dict = {}


def _reference(jax, arch: str):
    """The jitted reference's loss and gradient of ``arch`` on its batch."""
    if arch not in _REF:
        from repro.configs import get_smoke_config as ref_config
        from repro.models.registry import build as ref_build

        model = ref_build(ref_config(arch))
        _REF[arch] = jax.jit(jax.value_and_grad(model.loss))(ref_params(jax, arch),
                                                              _batch(arch))
    return _REF[arch]


def _op_by_op(jax, arch: str):
    """The reference's loss and gradient of the moe family on its batch, op
    by op: layers unrolled, no remat, not jitted (the module's note)."""
    key = (arch, "op by op")
    if key not in _REF:
        from repro.configs import get_smoke_config as ref_config
        from repro.models.registry import build as ref_build

        model = ref_build(ref_config(arch).replace(scan_layers=False, remat="none"))
        _REF[key] = jax.value_and_grad(model.loss)(ref_params(jax, arch), _batch(arch))
    return _REF[key]


def _ref_grads(jax, family: str):
    arch = ARCHS[family]
    return (_op_by_op if family == "moe" else _reference)(jax, arch)[1]


def _port(jax, arch: str):
    cfg = get_smoke_config(arch)
    model = params_from_reference(ref_params(jax, arch), cfg, device="cpu").release()
    loss = registry.loss(model, {k: torch.from_numpy(v) for k, v in _batch(arch).items()})
    loss.backward()
    return model, loss


@pytest.mark.parametrize("family", list(ARCHS))
def test_loss_and_grads_match_jitted_reference(jax, family):
    arch = ARCHS[family]
    loss_ref, g_ref = _reference(jax, arch)[0], _ref_grads(jax, family)
    model, loss = _port(jax, arch)
    assert abs(loss.item() - float(loss_ref)) <= 1e-3 * abs(float(loss_ref))
    for name, p in model.named_parameters():
        assert p.grad is not None and p.grad.abs().max() > 0, name
    grads = stack_layers({n: p.grad for n, p in model.named_parameters()}, model.stacks())
    got, want = T.flatten_with_paths(grads), jax.tree_util.tree_flatten_with_path(g_ref)[0]
    assert len(got) == len(want) == LEAVES[family]
    for (path, g), (ref_path, w) in zip(got, want):
        assert path == tuple(getattr(k, "key", getattr(k, "idx", None)) for k in ref_path)
        w, g = np.asarray(w), g.numpy()
        assert g.shape == w.shape, path
        assert np.linalg.norm(g - w) <= GRAD_L2 * np.linalg.norm(w), path
        assert np.abs(g - w).max() <= GRAD_MAX * np.abs(w).max(), path


SHARDED = ("vlm", "ssm", "audio")


def _rank_sharded(params: dict) -> dict:
    """Each of ``SHARDED``'s families on (data 2, model 2), FSDP: this
    rank's loss averaged over ``data`` and the logical gradient (the step's
    mean over ``data`` and agreement over ``model``, each leaf gathered),
    by family."""
    import traceback

    from repro_torch.configs.base import ShardingConfig
    from repro_torch.train import step as step_mod

    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    out = {}
    for family in SHARDED:
        try:
            arch = ARCHS[family]
            tr = ReconfigurableTrainer(get_smoke_config(arch), SHAPE, mesh,
                                       sharding=ShardingConfig(fsdp=True), transport="xla")
            tr.init_state(params=params[family])
            layout = tr._layout
            local = step_mod.local_rows(_batch(arch), mesh)
            loss = registry.loss(tr.model, local, batch_split=2)
            loss.backward()
            grads = {n: p.grad for n, p in tr.model.named_parameters()}
            grads = step_mod._mean_auto(grads, mesh, "data", layout)
            grads = step_mod._agree_over(grads, mesh, "model", layout)
            grads = {n: layout.full(n, g).numpy() for n, g in grads.items()}
            mean = step_mod._mean_over(loss.detach().reshape(1), mesh, ["data"]).item()
            out[family] = (mean, grads, sum(1 for n in grads if layout.splits[n]))
        except Exception:
            out[family] = traceback.format_exc()
    return out


@pytest.fixture(scope="module")
def sharded_ranks(jax):
    from repro_torch.launch.mesh import spawn

    params = {f: ref_params(jax, ARCHS[f]) for f in SHARDED}
    ranks = spawn("test_torch_train_families:_rank_sharded", 4, backend="gloo",
                  args=(params,), threads=1, timeout_s=600.0)
    for r, out in enumerate(ranks):
        for family, val in out.items():
            assert not isinstance(val, str), f"rank {r}, {family}:\n{val}"
    return ranks


@pytest.mark.parametrize("family", SHARDED)
def test_sharded_step_matches_one_rank(jax, sharded_ranks, family):
    model, loss = _port(jax, ARCHS[family])
    want = {n: p.grad.numpy() for n, p in model.named_parameters()}
    for r in sharded_ranks:
        got_loss, grads, n_split = r[family]
        assert n_split > 0
        assert abs(got_loss - loss.item()) <= 1e-3 * abs(loss.item())
        assert sorted(grads) == sorted(want)
        for name, w in want.items():
            g = grads[name]
            assert g.shape == w.shape, name
            assert np.linalg.norm(g - w) <= GRAD_L2 * np.linalg.norm(w), name
            assert np.abs(g - w).max() <= GRAD_MAX * np.abs(w).max(), name


@pytest.mark.parametrize("family", list(ARCHS))
def test_flat_gradient_is_the_references(jax, family):
    """``ravel_pytree`` of the reference's gradient against the port's flat
    vector (``repro_torch.tree`` over ``stack_layers``), leaf by leaf: the
    same boundaries, and within the gradient bound in each."""
    from jax.flatten_util import ravel_pytree

    arch = ARCHS[family]
    g_ref = _ref_grads(jax, family)
    model, _ = _port(jax, arch)
    tree = stack_layers({n: p.grad for n, p in model.named_parameters()}, model.stacks())
    flat = torch.cat([l.reshape(-1) for l in T.leaves(tree)]).numpy()
    want = np.asarray(ravel_pytree(g_ref)[0])
    assert flat.shape == want.shape
    off = 0
    for w in jax.tree.leaves(g_ref):
        n = int(np.prod(w.shape))
        g, w = flat[off:off + n], want[off:off + n]
        assert np.linalg.norm(g - w) <= GRAD_L2 * np.linalg.norm(w), off
        off += n
    assert off == flat.size


@pytest.mark.parametrize("family", list(ARCHS))
def test_transport_state_has_the_reference_leaves(jax, family):
    """The compressed transport's error-feedback residuals on a mesh with a
    ``pod`` axis: one per reference leaf, in its order and shape."""
    from repro import compat
    from repro.configs import get_smoke_config as ref_config
    from repro.launch.mesh import make_test_mesh as ref_mesh
    from repro.train.trainer import HostSpec as RefHost
    from repro.train.trainer import ReconfigurableTrainer as RefTrainer

    arch, transport = ARCHS[family], "compressed_int8"
    mesh = ref_mesh((1, 1), ("pod", "data"))
    with compat.use_mesh(mesh):
        ref = RefTrainer(ref_config(arch), SHAPE, mesh, transport=transport,
                         hosts=[RefHost(0, [transport])])
        want = jax.tree_util.tree_flatten_with_path(ref.init_state(jax.random.PRNGKey(0)).comm)[0]
    tr = ReconfigurableTrainer(get_smoke_config(arch), SHAPE,
                               make_mesh((1, 1), ("pod", "data"), device="cpu"),
                               transport=transport, hosts=[HostSpec(0, [transport])])
    got = T.flatten_with_paths(tr.init_state(0).comm)
    assert len(got) == len(want) == LEAVES[family]
    for (path, g), (ref_path, w) in zip(got, want):
        assert path == tuple(getattr(k, "key", getattr(k, "idx", None)) for k in ref_path)
        assert tuple(np.shape(g)) == tuple(w.shape)


@pytest.mark.parametrize("family", list(ARCHS))
def test_trainer_matches_reference_trainer(jax, family):
    """10 one-rank steps (``xla``) from the reference's parameters, against
    the reference trainer on a (1, 1) mesh: within 2e-2 relative."""
    from repro import compat
    from repro.configs import get_smoke_config as ref_config
    from repro.configs.base import TrainConfig as RefTrainConfig
    from repro.data.synthetic import batches_for as ref_batches
    from repro.launch.mesh import make_test_mesh as ref_mesh
    from repro.train.trainer import ReconfigurableTrainer as RefTrainer

    arch = ARCHS[family]
    mesh = ref_mesh((1, 1))
    # jax.set_mesh scopes the mesh for jit on jax 0.9, over any mesh an
    # earlier test left set process-wide (tests/test_substrate.py does)
    with (jax.set_mesh(mesh) if hasattr(jax, "set_mesh") else compat.use_mesh(mesh)):
        tcfg = RefTrainConfig(learning_rate=TCFG.learning_rate, warmup_steps=TCFG.warmup_steps,
                              total_steps=TCFG.total_steps)
        ref = RefTrainer(ref_config(arch), SHAPE, mesh, tcfg=tcfg)
        _, hist = ref.run(ref.init_state(jax.random.PRNGKey(0)),
                          ref_batches(ref_config(arch), SHAPE), 10)
        want = [float(h["loss"]) for h in hist]
    cfg = get_smoke_config(arch)
    tr = ReconfigurableTrainer(cfg, SHAPE, make_mesh((1,), ("data",), device="cpu"), tcfg=TCFG)
    _, hist = tr.run(tr.init_state(params=ref_params(jax, arch)), batches_for(cfg, SHAPE), 10)
    got = [h["loss"] for h in hist]
    assert all(math.isfinite(l) for l in got)
    np.testing.assert_allclose(got, want, rtol=2e-2)


def _capture_routes(module, monkeypatch, to_numpy) -> list:
    """Every ``route`` call's (router input, expert ids), through
    ``module.route``."""
    seen = []
    real = module.route

    def route(router, x, cfg):
        out = real(router, x, cfg)
        seen.append((to_numpy(x).astype(np.float32), to_numpy(out[1]).astype(np.int64)))
        return out

    monkeypatch.setattr(module, "route", route)
    return seen


def test_moe_expert_ids_agree_with_reference(jax, monkeypatch):
    """The top-k expert ids of every token in every layer, the port's
    forward against the op-by-op reference's (whose ids are concrete): the
    same experts for every token, in the same order but where the
    reference's two gate values are a near-tie (the module's note)."""
    from repro.configs import get_smoke_config as ref_config
    from repro.models import moe as rmoe

    arch = ARCHS["moe"]
    batch, params = _batch(arch), ref_params(jax, arch)
    want = _capture_routes(rmoe, monkeypatch, np.asarray)
    rmoe.hidden_states(params, batch["tokens"],
                       ref_config(arch).replace(scan_layers=False, remat="none"))
    got = _capture_routes(tmoe, monkeypatch,
                          lambda t: (t.detach().float() if t.is_floating_point() else t).numpy())
    model = params_from_reference(params, get_smoke_config(arch), device="cpu").release()
    model.hidden_states(torch.from_numpy(batch["tokens"]))
    assert len(got) == len(want) == get_smoke_config(arch).num_layers
    for layer, ((_, g), (x, w)) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(np.sort(g, axis=1), np.sort(w, axis=1))
        router = params["layers"]["moe"]["router"]["w"][layer]
        probs = np.asarray(jax.nn.softmax(x @ router, axis=-1))
        for t in np.argwhere((g != w).any(axis=1))[:, 0]:
            top = np.sort(probs[t][w[t]])[::-1]
            assert top[0] - top[-1] <= NEAR_TIE * top[0], (layer, t, probs[t][w[t]])


def test_moe_aux_share_of_the_loss(jax):
    """The layers' summed aux against the op-by-op reference's
    ``moe.hidden_states`` and the loss less it against its LM loss, each
    within 1e-3 (relative): the aux reads slot 0's experts, so the two
    near-tied tokens' order moves it by 7e-4."""
    from repro.configs import get_smoke_config as ref_config
    from repro.models import layers as rlayers
    from repro.models import moe as rmoe
    from repro.models import transformer as rtransformer

    arch = ARCHS["moe"]
    batch = _batch(arch)
    cfg = ref_config(arch).replace(scan_layers=False, remat="none")
    params = ref_params(jax, arch)
    h, aux_ref = rmoe.hidden_states(params, batch["tokens"], cfg)
    lm_ref = float(rlayers.chunked_lm_loss(h, rtransformer.head_weight(params, cfg),
                                           batch["labels"], chunk=cfg.loss_chunk,
                                           real_vocab=cfg.vocab_size))
    aux_ref = float(aux_ref)
    model = params_from_reference(params, get_smoke_config(arch), device="cpu").release()
    with torch.no_grad():
        _, aux = model.hidden_states(torch.from_numpy(batch["tokens"]))
        loss = model.loss({k: torch.from_numpy(v) for k, v in batch.items()})
    assert aux.item() > 0
    assert abs(aux.item() - aux_ref) <= 1e-3 * aux_ref
    assert abs((loss - aux).item() - lm_ref) <= 1e-3 * lm_ref


@pytest.mark.parametrize("seq", [4, 8])
def test_vlm_patches_need_the_sequence(jax, seq):
    """S < P: the reference fails in its rope (``ValueError``), the port
    raises a ``ValueError`` that names the constraint. S = P: both take
    the loss over the patches alone, within 1e-3."""
    from repro.configs import get_smoke_config as ref_config
    from repro.models.registry import build as ref_build

    arch = ARCHS["vlm"]
    P = get_smoke_config(arch).frontend.num_positions
    batch = _batch(arch, seq)
    params = ref_params(jax, arch)
    model = params_from_reference(params, get_smoke_config(arch), device="cpu").release()
    port_batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    if seq < P:
        with pytest.raises(ValueError, match="Incompatible shapes"):
            ref_build(ref_config(arch)).loss(params, batch)
        with pytest.raises(ValueError, match="patch positions do not fit"):
            model.loss(port_batch)
        return
    assert seq == P
    want = float(ref_build(ref_config(arch)).loss(params, batch))
    assert abs(model.loss(port_batch).item() - want) <= 1e-3 * want
