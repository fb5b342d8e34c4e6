"""AdamW with decoupled weight decay + global-norm clipping, on trees of
tensors.

The counterpart of ``src/repro/optim/adamw.py``, as plain functions (not
``torch.optim``). Moments are stored in ``TrainConfig.opt_dtype`` (bfloat16)
and updated in float32; the bias corrections are ``1 - b ** count`` in
float32. Unlike the reference, ``update`` works in place: each parameter and
moment tensor is overwritten with its new value (the full-width model has no
room for a second copy), and the same tensors are returned.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from repro_torch import tree as T
from repro_torch.configs.base import TrainConfig


class AdamWState(NamedTuple):
    m: dict
    v: dict
    count: int


def init(params, dtype=torch.bfloat16) -> AdamWState:
    def zeros():
        return T.map(lambda p: torch.zeros(p.shape, dtype=dtype, device=p.device), params)
    return AdamWState(m=zeros(), v=zeros(), count=0)


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                          for g in T.leaves(tree)))


def clip_by_global_norm(tree, max_norm: float):
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return T.map(lambda g: g * scale, tree), norm


def _f32(x: float) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def update(grads, state: AdamWState, params, lr: float, cfg: TrainConfig):
    """One AdamW step, in place. Returns (params, new_state, metrics)."""
    grads = T.map(lambda g: g.to(torch.float32), grads)
    if cfg.grad_clip > 0:
        grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    else:
        gnorm = global_norm(grads)
    count = state.count + 1
    b1, b2 = cfg.beta1, cfg.beta2
    c1 = float(1 - _f32(b1) ** _f32(count))
    c2 = float(1 - _f32(b2) ** _f32(count))
    with torch.no_grad():
        for p, g, m, v in zip(T.leaves(params), T.leaves(grads), T.leaves(state.m),
                              T.leaves(state.v)):
            m.copy_(b1 * m.to(torch.float32) + (1 - b1) * g)
            v.copy_(b2 * v.to(torch.float32) + (1 - b2) * g * g)
            mm, vv = m.to(torch.float32), v.to(torch.float32)
            step = (mm / c1) / (torch.sqrt(vv / c2) + cfg.eps)
            pf = p.to(torch.float32)
            p.copy_(pf - lr * (step + cfg.weight_decay * pf))
    return params, AdamWState(m=state.m, v=state.v, count=count), {"grad_norm": gnorm}


def lr_schedule(cfg: TrainConfig) -> Callable[[int], float]:
    """Linear warm-up, then cosine decay to a tenth, in float32."""
    def lr(step: int) -> float:
        s = _f32(float(step))
        warm = torch.clamp((s + 1) / max(cfg.warmup_steps, 1), max=1.0)
        prog = torch.clamp((s - cfg.warmup_steps)
                           / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
        cos = 0.5 * (1 + torch.cos(math.pi * prog))
        return float(cfg.learning_rate * warm * (0.1 + 0.9 * cos))

    return lr
