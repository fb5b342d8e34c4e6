"""The port's remat policies against the reference's semantics
(``src/repro/models/stacking.py``): ``remat_group=g`` checkpoints each run
of g layers as one unit where the stack's length divides by g and is longer
than g, and ``remat="dots"`` (``checkpoint_dots_with_no_batch_dims``) keeps
the outputs of the 2-D products and recomputes the rest. Each keeps the
loss and the gradients of ``"full"``; what differs is what backward holds
and recomputes.
"""
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import get_smoke_config
from repro_torch.models import registry, stacking
from repro_torch.models.stacking import DOTS, apply_stack, group_size

L, D = 4, 16


class _OpCount(TorchDispatchMode):
    """How often each aten op runs while the mode is on."""

    def __init__(self):
        super().__init__()
        self.ops = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[func] = self.ops.get(func, 0) + 1
        return func(*args, **(kwargs or {}))

    def count(self, ops) -> int:
        return sum(n for op, n in self.ops.items() if op in ops)


def _stack():
    torch.manual_seed(0)
    return torch.nn.ModuleList(torch.nn.Linear(D, D) for _ in range(L))


def _body(layer, h):
    return h + torch.tanh(layer(h)) * 2.0


def _run(layers, policy, group):
    """(output, tensors saved for backward outside the checkpoints, backward's
    op counts, input gradient)."""
    x = torch.randn(2, 3, D, generator=torch.Generator().manual_seed(1), requires_grad=True)
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append(t) or t, lambda t: t):
        y = apply_stack(layers, x, _body, remat_policy=policy, remat_group=group)
    ops = _OpCount()
    with ops:
        y.sum().backward()
    return y, saved, ops, x.grad


@pytest.mark.parametrize("n,g,want", [(4, 2, 2), (4, 1, 1), (4, 4, 1), (6, 4, 1), (3, 2, 1),
                                      (88, 2, 2), (94, 2, 2), (1, 2, 1)])
def test_group_size_is_the_reference_rule(n, g, want):
    assert group_size(n, g) == want


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_group_saves_one_boundary_per_group(policy):
    """A 4-layer stack at g = 2 keeps L/g = 2 boundary activations (each
    group's input) for backward, at g = 1 four; each layer is recomputed
    once either way."""
    layers = _stack()
    runs = {g: _run(layers, policy, g) for g in (1, 2)}
    assert [len(runs[g][1]) for g in (1, 2)] == [L, L // 2]
    assert all(s.shape == (2, 3, D) for s in runs[2][1])
    tanh = torch.ops.aten.tanh.default
    assert runs[1][2].ops[tanh] == runs[2][2].ops[tanh] == L  # one recompute a layer


def test_none_keeps_every_activation():
    y, saved, ops, _ = _run(_stack(), "none", 1)
    assert len(saved) > L and ops.ops.get(torch.ops.aten.tanh.default, 0) == 0


def test_dots_keeps_the_products_and_recomputes_the_rest(monkeypatch):
    """Under ``"dots"`` backward runs the products' own gradients only (as
    with no remat), never a forward product again, and recomputes each
    layer's elementwise ops; the policy saves only ``aten.mm``/``addmm``."""
    saved_ops = []
    policy = stacking.dots_policy

    def recording(ctx, op, *args, **kwargs):
        decision = policy(ctx, op, *args, **kwargs)
        if decision == torch.utils.checkpoint.CheckpointPolicy.MUST_SAVE:
            saved_ops.append(op)
        return decision

    monkeypatch.setattr(stacking, "dots_policy", recording)
    layers = _stack()
    _, _, dots, _ = _run(layers, "dots", 1)
    _, _, none, _ = _run(layers, "none", 1)
    _, _, full, _ = _run(layers, "full", 1)
    assert dots.count(DOTS) == none.count(DOTS) < full.count(DOTS)
    assert dots.ops[torch.ops.aten.tanh.default] == L
    assert saved_ops and set(saved_ops) <= set(DOTS) and len(saved_ops) == L


def test_unknown_policy_raises():
    with pytest.raises(ValueError, match="remat policy"):
        apply_stack(_stack(), torch.zeros(1, D), _body, remat_policy="offload")


def _loss_and_grads(cfg):
    model = registry.build(cfg, device="cpu", seed=0).release()
    g = torch.Generator().manual_seed(2)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 32), generator=g),
             "labels": torch.randint(0, cfg.vocab_size, (2, 32), generator=g)}
    loss = registry.loss(model, batch)
    loss.backward()
    return loss.detach(), {n: p.grad for n, p in model.named_parameters()}


@pytest.mark.parametrize("remat,group", [("full", 2), ("dots", 1), ("dots", 2), ("none", 1)])
def test_loss_and_grads_equal_full(remat, group):
    """A 4-layer llama (smoke widths): the loss and every gradient under
    each policy equal those of ``"full"`` at g = 1, bit for bit."""
    base = get_smoke_config("llama3.2-1b").replace(num_layers=4)
    loss0, grads0 = _loss_and_grads(base.replace(remat="full", remat_group=1))
    loss, grads = _loss_and_grads(base.replace(remat=remat, remat_group=group))
    assert torch.equal(loss, loss0)
    for name, g in grads.items():
        assert torch.equal(g, grads0[name]), name


def test_models_pass_remat_group_through():
    """The dense family groups by ``cfg.remat_group`` (granite-34b sets 2),
    as the reference's transformer does; the hybrid family, whose reference
    stack takes no group, checkpoints every layer."""
    dense = registry.build(get_smoke_config("granite-34b").replace(num_layers=4),
                           device="meta")
    assert dense.cfg.remat_group == 2 and dense._remat_group() == 2
    unscanned = registry.build(dense.cfg.replace(scan_layers=False), device="meta")
    assert unscanned._remat_group() == 1  # the reference groups scanned stacks only
    hybrid = registry.build(get_smoke_config("hymba-1.5b").replace(remat_group=2),
                            device="meta")
    assert hybrid._remat_group() == 1
