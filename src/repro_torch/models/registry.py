"""Model classes by family, imported lazily: a family's module loads only
when a config of that family is built. The port serves the dense and hybrid
families and trains the dense one so far; the others raise and say they are
not ported yet.

``loss(model, batch)`` and ``batch_specs(cfg, shape)`` are the dense
family's rows of the reference's ``_Family`` table."""
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
TRAINED = ("dense",)


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


def build(cfg: ModelConfig, *, device="cuda", seed: int = 0):
    """The model of ``cfg`` on ``device``, its parameters drawn from a
    ``torch.Generator`` seeded with ``seed``."""
    dev = backend.resolve_device(device)
    cls = model_class(cfg)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return cls(cfg, device=dev, generator=gen)
