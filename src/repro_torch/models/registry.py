"""Model classes by family, imported lazily: a family's module loads only
when a config of that family is built. The port serves the dense and hybrid
families so far; the others raise and say they are not ported yet."""
from __future__ import annotations

import importlib

import torch

from repro_torch import backend
from repro_torch.configs.base import ModelConfig

#: family -> (module, class)
_FAMILIES = {"dense": ("repro_torch.models.transformer", "DenseLM"),
             "hybrid": ("repro_torch.models.hymba", "HymbaLM")}


def model_class(cfg: ModelConfig):
    if cfg.family not in _FAMILIES:
        raise KeyError(f"family {cfg.family!r} ({cfg.name}) is not ported yet; "
                       f"the port builds {sorted(_FAMILIES)}")
    module, name = _FAMILIES[cfg.family]
    return getattr(importlib.import_module(module), name)


def build(cfg: ModelConfig, *, device="cuda", seed: int = 0):
    """The model of ``cfg`` on ``device``, its parameters drawn from a
    ``torch.Generator`` seeded with ``seed``."""
    dev = backend.resolve_device(device)
    cls = model_class(cfg)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return cls(cfg, device=dev, generator=gen)
