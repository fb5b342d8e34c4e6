"""Model classes by family, imported lazily: a family's module loads only
when a config of that family is built. The port serves and trains the dense
and hybrid families; the others raise and say they are not ported yet.

``loss(model, batch)`` and ``batch_specs(cfg, shape)`` are the dense and
hybrid families' rows of the reference's ``_Family`` table (both take
tokens and labels). ``param_specs(model, sh, mesh)`` is the reference's
``Model.param_specs``: the spec of every leaf of the model's parameter tree
in the reference's layout (``stacking.stack_layers``)."""
from __future__ import annotations

import importlib

import torch

from repro_torch import backend
from repro_torch.configs.base import ModelConfig, ShapeConfig

#: family -> (module, class)
_FAMILIES = {"dense": ("repro_torch.models.transformer", "DenseLM"),
             "hybrid": ("repro_torch.models.hymba", "HymbaLM")}


def model_class(cfg: ModelConfig):
    if cfg.family not in _FAMILIES:
        raise KeyError(f"family {cfg.family!r} ({cfg.name}) is not ported yet; "
                       f"the port builds {sorted(_FAMILIES)}")
    module, name = _FAMILIES[cfg.family]
    return getattr(importlib.import_module(module), name)


#: the families the port trains
TRAINED = ("dense", "hybrid")


def _trained(cfg: ModelConfig) -> None:
    if cfg.family not in TRAINED:
        raise KeyError(f"training the {cfg.family!r} family ({cfg.name}) is not ported yet; "
                       f"the port trains {TRAINED}")


def loss(model, batch: dict) -> torch.Tensor:
    """The training loss of ``model`` on ``batch``."""
    _trained(model.cfg)
    return model.loss(batch)


def batch_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """name -> (shape, dtype) of a batch of ``shape``: tokens and labels,
    (B, S) int32, or tokens (B, 1) for decode."""
    _trained(cfg)
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        return {"tokens": ((B, 1), torch.int32)}
    return {"tokens": ((B, S), torch.int32), "labels": ((B, S), torch.int32)}


def param_shapes(model) -> dict:
    """The model's parameter tree in the reference's layout
    (``stacking.stack_layers``: layer leaves stacked), as meta tensors."""
    from repro_torch.models.stacking import stack_layers

    shapes = model.layout.shapes if getattr(model, "layout", None) is not None else None
    named = {n: torch.empty(shapes[n] if shapes else tuple(p.shape), device="meta")
             for n, p in model.named_parameters()}
    return stack_layers(named, model.cfg.num_layers,
                        stack=lambda ts: torch.empty((len(ts),) + tuple(ts[0].shape),
                                                     device="meta"))


def param_specs(model, sh, mesh=None):
    """The reference's ``Model.param_specs(sh)`` on ``mesh``: a tree of
    ``sharding.P`` over :func:`param_shapes`."""
    from repro_torch.models import sharding

    return sharding.param_specs(param_shapes(model), sh, mesh)


def build(cfg: ModelConfig, *, device="cuda", seed: int = 0):
    """The model of ``cfg`` on ``device``, its parameters drawn from a
    ``torch.Generator`` seeded with ``seed``."""
    dev = backend.resolve_device(device)
    cls = model_class(cfg)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return cls(cfg, device=dev, generator=gen)
