"""Layer stacking: the parts of ``src/repro/models/stacking.py`` the port
uses.

``apply_stack`` runs ``x`` through the layers one by one (the reference's
``scan`` has no counterpart: the port unrolls), each under
``torch.utils.checkpoint`` with ``remat="full"``, so backward recomputes a
layer's activations instead of keeping them. It is also the seam of a
sharded model (``sharding.Layout``): each layer's parameters are gathered
from their shards just for that layer's body.

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
from torch.utils.checkpoint import checkpoint


def remat(fn: Callable, policy: str) -> Callable:
    """``fn`` recomputed in backward (``"full"``) or kept (``"none"``)."""
    if policy == "none":
        return fn
    if policy == "full":
        return lambda *args: checkpoint(fn, *args, use_reentrant=False)
    raise NotImplementedError(f"remat policy {policy!r}: the port has 'none' and 'full'")


def apply_stack(layers: Sequence[torch.nn.Module], x: torch.Tensor, body: Callable, *,
                remat_policy: str = "full", static: Optional[Callable[[int], dict]] = None,
                gathered: Optional[Callable[[int], ContextManager]] = None) -> torch.Tensor:
    """``x`` through ``body(layer, x, **static(i))`` for each layer ``i`` in
    turn (``static``: the keywords of the reference's segment that holds
    layer ``i``). A sharded model passes ``gathered(i)``, under which layer
    ``i``'s parameters read as their full tensors: they are gathered from
    their shards before the body and freed after, and gathered again when
    ``remat`` recomputes the layer in backward."""
    def run(i: int, layer, h):
        kw = static(i) if static is not None else {}
        if gathered is None:
            return body(layer, h, **kw)
        with gathered(i):
            return body(layer, h, **kw)

    fn = remat(run, remat_policy)
    for i, layer in enumerate(layers):
        x = fn(i, layer, x)
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
