"""Architecture config registry of the port: ``--arch <id>`` resolves here.

``base.py`` and the ten arch modules are copies of the reference's; the port
serves every one of them. An unknown arch raises ``KeyError``.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (
    SHAPES,
    ModelConfig,
    ShapeConfig,
    ShardingConfig,
    TrainConfig,
    shape_applicable,
)

_ARCH_MODULES = {
    "qwen2-7b": "repro_torch.configs.qwen2_7b",
    "granite-34b": "repro_torch.configs.granite_34b",
    "llama3.2-1b": "repro_torch.configs.llama3_2_1b",
    "mistral-nemo-12b": "repro_torch.configs.mistral_nemo_12b",
    "qwen3-moe-235b-a22b": "repro_torch.configs.qwen3_moe_235b",
    "dbrx-132b": "repro_torch.configs.dbrx_132b",
    "xlstm-125m": "repro_torch.configs.xlstm_125m",
    "seamless-m4t-medium": "repro_torch.configs.seamless_m4t_medium",
    "phi-3-vision-4.2b": "repro_torch.configs.phi3_vision_4b",
    "hymba-1.5b": "repro_torch.configs.hymba_1_5b",
}

#: archs of the reference that the port does not serve yet: none
NOT_PORTED: tuple = ()

ARCH_IDS = tuple(_ARCH_MODULES)


def _module(arch: str):
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_ARCH_MODULES)}")
    return importlib.import_module(_ARCH_MODULES[arch])


def get_config(arch: str) -> ModelConfig:
    cfg = _module(arch).CONFIG
    cfg.validate()
    return cfg


def get_smoke_config(arch: str) -> ModelConfig:
    cfg = _module(arch).smoke_config()
    cfg.validate()
    return cfg


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]


__all__ = [
    "ARCH_IDS",
    "NOT_PORTED",
    "SHAPES",
    "ModelConfig",
    "ShapeConfig",
    "ShardingConfig",
    "TrainConfig",
    "get_config",
    "get_smoke_config",
    "get_shape",
    "shape_applicable",
]
