"""Trees of tensors, flattened in the reference's leaf order.

The reference walks its parameter, gradient and state trees with
``jax.tree``: a dict's children in sorted key order, a list's, tuple's or
NamedTuple's in their own order, ``None`` as a tree with no leaves, anything
else as a leaf. The port's trees are the same Python containers of tensors,
and these functions walk them in that order, so that a gradient flattened
here has the reference's block boundaries (``comm.collectives``) and a
checkpoint names its leaves as the reference does (``checkpoint.ckpt``).
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _children(node):
    """(keys, children, rebuild) of a container, or None for a leaf."""
    if node is None:
        return (), (), lambda vals: None
    if isinstance(node, dict):
        keys = sorted(node)
        return keys, [node[k] for k in keys], lambda vals: dict(zip(keys, vals))
    if _is_namedtuple(node):
        return node._fields, list(node), lambda vals: type(node)(*vals)
    if isinstance(node, (list, tuple)):
        return (tuple(range(len(node))), list(node),
                lambda vals: type(node)(vals))
    return None


def flatten_with_paths(tree) -> List[Tuple[Tuple[Any, ...], Any]]:
    """(path, leaf) for every leaf, in the reference's order; a path is the
    tuple of dict keys, field names and indices from the root."""
    out: list = []
    _walk(tree, (), out)
    return out


def _walk(node, path, out) -> None:
    # module level, not a closure: a nested recursive function is a
    # reference cycle, which would keep ``out`` and its leaves (a step's
    # gradients) alive until the cyclic collector runs
    kids = _children(node)
    if kids is None:
        out.append((path, node))
        return
    for k, child in zip(kids[0], kids[1]):
        _walk(child, path + (k,), out)


def leaves(tree) -> list:
    return [leaf for _, leaf in flatten_with_paths(tree)]


def unflatten(like, new_leaves) -> Any:
    """A tree of ``like``'s structure holding ``new_leaves`` in leaf order."""
    it = iter(new_leaves)
    out = _build(like, it)
    if next(it, it) is not it:
        raise ValueError("more leaves than the tree has")
    return out


def _build(node, it):
    # module level for the reason of ``_walk``
    kids = _children(node)
    if kids is None:
        return next(it)
    return kids[2]([_build(child, it) for child in kids[1]])


def map(fn: Callable, tree, *rest):
    """``fn`` applied leafwise over trees of one structure."""
    lv = leaves(tree)
    others = [leaves(t) for t in rest]
    for o in others:
        if len(o) != len(lv):
            raise ValueError(f"trees differ: {len(lv)} and {len(o)} leaves")
    return unflatten(tree, [fn(*args) for args in zip(lv, *others)])
