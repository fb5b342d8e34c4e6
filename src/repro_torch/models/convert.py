"""Parameters carried across from the reference's models into the port's.

``params_from_reference`` takes the reference's parameter tree as nested
dicts of numpy arrays (``np.asarray`` of each leaf of ``model.init(...)``),
layers stacked on a leading axis as ``stacking.stacked_init`` makes them,
and fills the port's model of the same config with them. It raises on any
leaf it did not use and on any parameter of the port it did not fill.
"""
from __future__ import annotations

from typing import Iterator, Mapping, Tuple

import numpy as np
import torch

from repro_torch import backend
from repro_torch.configs.base import ModelConfig
from repro_torch.models.registry import model_class


def flatten(tree: Mapping, prefix: str = "") -> Iterator[Tuple[str, object]]:
    """(dotted path, leaf) for every leaf of a nested dict."""
    for key, val in tree.items():
        path = f"{prefix}{key}"
        if isinstance(val, Mapping):
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
    cfg = model.cfg
    named = dict(model.named_parameters())
    filled, unused = set(), []
    for path, leaf in flatten(params):
        arr = np.asarray(leaf, dtype=np.float32)
        if path.startswith("layers."):
            if arr.shape[:1] != (cfg.num_layers,):
                raise ValueError(f"{path}: leading axis {arr.shape[:1]}, "
                                 f"want the {cfg.num_layers} layers")
            rest = path[len("layers."):]
            targets = [(f"layers.{i}.{rest}", arr[i]) for i in range(cfg.num_layers)]
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
