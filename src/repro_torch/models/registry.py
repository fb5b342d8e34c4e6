"""Model classes by family, imported lazily: a family's module loads only
when a config of that family is built. The port serves and trains every
family of the reference (dense, moe, ssm, hybrid, vlm, audio).

``loss(model, batch)`` is the reference's ``_Family.loss``: each family's
model has its own ``loss`` (the vlm batch carries ``patches``, the audio
batch ``frames``; the moe loss adds the load-balance aux).
``batch_specs(cfg, shape)`` is the reference's ``Model.batch_specs`` for
every family. ``param_specs(model, sh, mesh)`` is the reference's
``Model.param_specs``: the spec of every leaf of the model's parameter tree
in the reference's layout (``stacking.stack_layers`` over the model's
``stacks()``). ``cache_shapes(cfg, shape)`` is the reference's
``Model.cache_specs``."""
from __future__ import annotations

import importlib

import torch

from repro_torch import backend
from repro_torch.configs.base import ModelConfig, ShapeConfig

#: family -> (module, class)
_FAMILIES = {"dense": ("repro_torch.models.transformer", "DenseLM"),
             "moe": ("repro_torch.models.moe", "MoeLM"),
             "ssm": ("repro_torch.models.xlstm", "XlstmLM"),
             "hybrid": ("repro_torch.models.hymba", "HymbaLM"),
             "vlm": ("repro_torch.models.transformer", "VlmLM"),
             "audio": ("repro_torch.models.encdec", "EncDecLM")}


def model_class(cfg: ModelConfig):
    if cfg.family not in _FAMILIES:
        raise KeyError(f"unknown family {cfg.family!r} ({cfg.name}); "
                       f"the port builds {sorted(_FAMILIES)}")
    module, name = _FAMILIES[cfg.family]
    return getattr(importlib.import_module(module), name)


def loss(model, batch: dict, *, batch_split: int = 1) -> torch.Tensor:
    """The training loss of ``model`` on ``batch``. On a mesh, ``batch`` is
    the rank's rows, one of ``batch_split`` blocks of the global batch (the
    moe family's dispatch routes the global batch's tokens)."""
    return model.loss(batch, batch_split=batch_split)


def batch_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """name -> (shape, dtype) of the reference's batch of ``shape`` for any
    family: tokens (B, 1) for decode; else tokens and labels (B, S) int32,
    with ``patches`` (B, P, E) bfloat16 for vlm and ``frames``
    (B, max(1, S // src_ratio), E) bfloat16 for audio."""
    model_class(cfg)
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        return {"tokens": ((B, 1), torch.int32)}
    specs = {"tokens": ((B, S), torch.int32), "labels": ((B, S), torch.int32)}
    if cfg.family == "vlm":
        f = cfg.frontend
        specs["patches"] = ((B, f.num_positions, f.embed_dim), torch.bfloat16)
    if cfg.family == "audio":
        src = max(1, S // cfg.encdec.src_ratio)
        specs["frames"] = ((B, src, cfg.frontend.embed_dim), torch.bfloat16)
    return specs


def param_shapes(model) -> dict:
    """The model's parameter tree in the reference's layout
    (``stacking.stack_layers`` over its ``stacks()``: layer leaves stacked),
    as meta tensors."""
    from repro_torch.models.stacking import stack_layers

    shapes = model.layout.shapes if getattr(model, "layout", None) is not None else None
    named = {n: torch.empty(shapes[n] if shapes else tuple(p.shape), device="meta")
             for n, p in model.named_parameters()}
    return stack_layers(named, model.stacks(),
                        stack=lambda ts: torch.empty((len(ts),) + tuple(ts[0].shape),
                                                     device="meta"))


def param_specs(model, sh, mesh=None):
    """The reference's ``Model.param_specs(sh)`` on ``mesh``: a tree of
    ``sharding.P`` over :func:`param_shapes`."""
    from repro_torch.models import sharding

    return sharding.param_specs(param_shapes(model), sh, mesh)


def cache_shapes(cfg: ModelConfig, shape: ShapeConfig):
    """The reference's ``Model.cache_specs(shape)``: the cache tree of
    ``shape.global_batch`` rows and ``shape.seq_len`` positions as meta
    tensors (``"len"`` an int), from a model on the meta device."""
    model = model_class(cfg)(cfg, device=torch.device("meta"))
    return model.init_cache(shape.global_batch, shape.seq_len)


def build(cfg: ModelConfig, *, device="cuda", seed: int = 0, mesh=None,
          decode_attn_fn=None):
    """The model of ``cfg`` on ``device``, its parameters drawn from a
    ``torch.Generator`` seeded with ``seed``; ``decode_attn_fn`` is its
    decode's KV-partition slot (``comm.kvshard``; the local attention where
    None). With a ``mesh`` (the rank's, the reference's ``build(cfg,
    mesh)``) the model is drawn in full but makes no serving copies: a
    sharded serve step (``serving.steps``) lays its parameters out and
    makes them from the blocks.

    On the ``"meta"`` device (``launch.dryrun``) the model has every
    parameter's shape and no data: nothing is drawn, and no memory is
    taken."""
    if torch.device(device).type == "meta":
        model = model_class(cfg)(cfg, device=torch.device("meta"))
    else:
        dev = backend.resolve_device(device)
        model = model_class(cfg)(cfg, device=dev)
        model.init_weights(torch.Generator(device=dev).manual_seed(seed))
    model.mesh, model.decode_attn_fn = mesh, decode_attn_fn
    return model if mesh is not None else model.prepare()
