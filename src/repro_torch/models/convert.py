"""Parameters carried across from the reference's models into the port's.

``params_from_reference`` takes the reference's parameter tree as nested
dicts and lists of numpy arrays (``np.asarray`` of each leaf of
``model.init(...)``), and fills the port's model of the same config with
them. The stacks of the model's ``stacks()`` (``layers``; ``encoder`` and
``decoder`` for the encoder-decoder) hold their layers on a leading axis, as
``stacking.stacked_init`` makes them; a list of layers (xlstm's) is walked by
index (``layers.{i}.<leaf>``). It raises on any leaf it did not use and on
any parameter of the port it did not fill.
"""
from __future__ import annotations

from typing import Iterator, Mapping, Tuple

import numpy as np
import torch

from repro_torch import backend
from repro_torch.configs.base import ModelConfig
from repro_torch.models.registry import model_class


def flatten(tree, prefix: str = "") -> Iterator[Tuple[str, object]]:
    """(dotted path, leaf) for every leaf of nested dicts and lists (a list
    item's key is its index)."""
    items = tree.items() if isinstance(tree, Mapping) else enumerate(tree)
    for key, val in items:
        path = f"{prefix}{key}"
        if isinstance(val, (Mapping, list, tuple)):
            yield from flatten(val, path + ".")
        else:
            yield path, val


def params_from_reference(params: Mapping, cfg: ModelConfig, *, device="cuda"):
    """The port's model of ``cfg`` on ``device`` holding ``params``, with its
    serving copies made (``release()`` it to train)."""
    model = model_class(cfg)(cfg, device=backend.resolve_device(device))
    return fill_from_reference(model, params).prepare()


def fill_from_reference(model, params: Mapping):
    """``model``'s parameters set from the reference's tree ``params``, in
    place; returns the model."""
    stacks = model.stacks()
    named = dict(model.named_parameters())
    filled, unused = set(), []
    for path, leaf in flatten(params):
        arr = np.asarray(leaf, dtype=np.float32)
        head, _, rest = path.partition(".")
        if head in stacks:
            n = stacks[head]
            if arr.shape[:1] != (n,):
                raise ValueError(f"{path}: leading axis {arr.shape[:1]}, want the {n} layers")
            targets = [(f"{head}.{i}.{rest}", arr[i]) for i in range(n)]
        else:
            targets = [(path, arr)]
        if any(name not in named for name, _ in targets):
            unused.append(path)
            continue
        for name, a in targets:
            p = named[name]
            if tuple(p.shape) != a.shape:
                raise ValueError(f"{path}: shape {a.shape}, the port's {name} is {tuple(p.shape)}")
            with torch.no_grad():
                p.copy_(torch.from_numpy(np.array(a)))
            filled.add(name)
    if unused:
        raise ValueError(f"reference leaves with no parameter in the port: {unused}")
    missing = sorted(set(named) - filled)
    if missing:
        raise ValueError(f"parameters of the port the reference did not fill: {missing}")
    return model
