"""Layer stacking: the parts of ``src/repro/models/stacking.py`` the port
uses.

``apply_stack`` runs ``x`` through the layers one by one (the reference's
``scan`` has no counterpart: the port unrolls), each under
``torch.utils.checkpoint`` with ``remat="full"``, so backward recomputes a
layer's activations instead of keeping them. ``remat="dots"`` keeps the
outputs of the layer's 2-D products and recomputes the rest, and
``remat_group=g`` checkpoints each run of g layers as one unit, with the
reference's semantics (``remat``, ``apply_stack``). It is also the seam of a
sharded model (``sharding.Layout``): each layer's parameters are gathered
from their shards just for that layer's body (under the compute split over
``model``, ``pshard.Split``, the ones it splits keep their ``model`` block:
the model's ``gathered`` passes the split's reads through).

Hazard: a body recomputed under ``torch.utils.checkpoint`` issues
collectives (the parameters' gathers; under the split, the row products'
sums, or on the sequence-parallel residual the gathers and reduce-scatters
over S). Every rank runs the same body on the same schedule, so the
recomputation issues the same collectives in the same order on every rank.
It stops at the body's last saved activation, so a collective after it (a
split layer's final "g", ``down``'s) is not issued again;
``analysis.roofline`` counts what runs, held to ``collectives.SENT``.

``stack_layers``/``unstack_layers`` move between the port's per-layer
parameters, named ``<stack>.{i}.<leaf>``, and the reference's tree, where each
layer leaf is stacked on a leading layer axis and dicts nest by name: the
tree the gradient transports flatten, in the reference's leaf order. A
model's ``stacks()`` names its stacks: ``layers`` for most families,
``encoder`` and ``decoder`` for the encoder-decoder, none for xlstm, whose
unlike layers the reference keeps as a list (``layers.{i}.<leaf>`` nests as
``layers[i]``).
"""
from __future__ import annotations

from typing import Callable, ContextManager, Dict, Mapping, Optional, Sequence

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch.obs.ranges import spanned


#: the 2-D products whose outputs ``"dots"`` keeps: ``aten.mm`` and
#: ``aten.addmm`` (a ``Linear`` on (B, S, D) folds into one); ``bmm`` and
#: batched ``einsum`` products, over heads or experts, are recomputed
DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def dots_policy(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    """``jax.checkpoint_policies.checkpoint_dots_with_no_batch_dims``: save
    the outputs of matrix products without a batch dimension, recompute
    everything else."""
    return CheckpointPolicy.MUST_SAVE if op in DOTS else CheckpointPolicy.PREFER_RECOMPUTE


@spanned("model.remat")
def _unit(fn: Callable, *args):
    """``fn(*args)``, a unit that ``remat`` checkpoints: the span holds its
    forward and, in backward, its recomputation, so that the recomputed
    operations no finer span holds are not put down to the backward range
    open when autograd first unpacks one of the unit's saved tensors."""
    return fn(*args)


def remat(fn: Callable, policy: str) -> Callable:
    """``fn`` recomputed in backward (``"full"``), recomputed but for its
    2-D products' outputs (``"dots"``), or kept (``"none"``)."""
    if policy == "none":
        return fn
    if policy == "full":
        return lambda *args: checkpoint(_unit, fn, *args, use_reentrant=False)
    if policy == "dots":
        return lambda *args: checkpoint(
            _unit, fn, *args, use_reentrant=False,
            context_fn=lambda: create_selective_checkpoint_contexts(dots_policy))
    raise ValueError(f"remat policy {policy!r}: use 'none', 'full' or 'dots'")


def group_size(num_layers: int, remat_group: int) -> int:
    """The layers checkpointed as one unit: ``remat_group`` where the
    stack's length divides by it and is longer than it, else 1 (the
    reference's rule, ``apply_stack``)."""
    if remat_group > 1 and num_layers % remat_group == 0 and num_layers > remat_group:
        return remat_group
    return 1


def apply_stack(layers: Sequence[torch.nn.Module], x, body: Callable, *,
                remat_policy: str = "full", remat_group: int = 1,
                static: Optional[Callable[[int], dict]] = None,
                gathered: Optional[Callable[[int], ContextManager]] = None):
    """``x`` through ``body(layer, x, **static(i))`` for each layer ``i`` in
    turn (``static``: the keywords of the reference's segment that holds
    layer ``i``). ``x`` is the carry: a tensor, or a tuple of them (the moe
    family carries its summed aux loss beside the residual stream). Each run of ``group_size(len(layers), remat_group)``
    layers is one ``remat`` unit: backward keeps its input and recomputes
    its layers, each once. A sharded model passes ``gathered(i)``, under
    which layer ``i``'s parameters read as their full tensors: they are
    gathered from their shards before the body and freed after, and
    gathered again when ``remat`` recomputes the layer in backward."""
    def run(first: int, g: int, h):
        for i in range(first, first + g):
            kw = static(i) if static is not None else {}
            if gathered is None:
                h = body(layers[i], h, **kw)
            else:
                with gathered(i):
                    h = body(layers[i], h, **kw)
        return h

    g = group_size(len(layers), remat_group)
    fn = remat(run, remat_policy)
    for first in range(0, len(layers), g):
        x = fn(first, g, x)
    return x


def _nest(flat: Mapping[str, object]) -> dict:
    """Dotted names -> nested dicts; a dict whose keys are exactly
    ``0 .. n-1`` becomes a list (layers the reference keeps unstacked, as
    xlstm's, are a list there)."""
    out: dict = {}
    for name, leaf in flat.items():
        node = out
        *head, last = name.split(".")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = leaf

    def lists(node):
        if not isinstance(node, dict):
            return node
        node = {k: lists(v) for k, v in node.items()}
        if node and sorted(node) == sorted(str(i) for i in range(len(node))):
            return [node[str(i)] for i in range(len(node))]
        return node

    return lists(out)


def stack_layers(named: Mapping[str, torch.Tensor], stacks: Mapping[str, int],
                 stack: Callable = torch.stack) -> dict:
    """The reference's tree of ``named``: for each ``prefix -> count`` of
    ``stacks`` (a model's ``stacks()``), the leaves ``prefix.{i}.<leaf>``
    of its ``count`` layers stacked by ``stack`` on a leading axis as
    ``prefix.<leaf>``; other names as they are, numbered ones (an unstacked
    list of layers) nested as lists."""
    flat: Dict[str, object] = {}
    per_leaf: Dict[tuple, list] = {}
    for name, t in named.items():
        prefix, _, tail = name.partition(".")
        if prefix in stacks:
            i, rest = tail.split(".", 1)
            per_leaf.setdefault((prefix, rest), [None] * stacks[prefix])[int(i)] = t
        else:
            flat[name] = t
    for (prefix, rest), ts in per_leaf.items():
        if any(t is None for t in ts):
            raise ValueError(f"{prefix}.*.{rest}: not every layer has it")
        flat[f"{prefix}.{rest}"] = stack(ts)
    return _nest(flat)


def unstack_layers(tree, stacks: Mapping[str, int], prefix: str = "") -> Dict[str, torch.Tensor]:
    """``stack_layers``'s inverse: dotted names -> tensors, each layer's a
    view of its stacked leaf."""
    out: Dict[str, torch.Tensor] = {}
    items = tree.items() if isinstance(tree, Mapping) else enumerate(tree)
    for k, v in items:
        name = f"{prefix}{k}"
        if isinstance(v, (Mapping, list, tuple)):
            out.update(unstack_layers(v, stacks, name + "."))
            continue
        head, _, rest = name.partition(".")
        if head in stacks:
            for i in range(stacks[head]):
                out[f"{head}.{i}.{rest}"] = v[i]
        else:
            out[name] = v
    return out
