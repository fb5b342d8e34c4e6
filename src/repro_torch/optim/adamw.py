"""AdamW with decoupled weight decay + global-norm clipping, on trees of
tensors.

The counterpart of ``src/repro/optim/adamw.py``, as plain functions (not
``torch.optim``). Moments are stored in ``TrainConfig.opt_dtype`` (bfloat16)
and updated in float32; the bias corrections are ``1 - b ** count`` in
float32. Unlike the reference, ``update`` works in place: each parameter and
moment tensor is overwritten with its new value (the full-width model has no
room for a second copy), and the same tensors are returned.

On a mesh, each leaf may come with a :class:`LeafShard` (``shards=``): its
parameter and gradient are the rank's block, split over ``norm_axes``, so the
global norm sums each rank's squares and all-reduces them over those axes
(each element counted once). With ``zero1_dim`` the moments are ZeRO-1
shards: they hold the rank's ``pod`` block of that dim of the parameter's
block; the rank updates that part of the parameter and all-gathers it over
``pod``, so the parameter stays bit-equal on every ``pod`` rank.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from repro_torch import tree as T
from repro_torch.comm import collectives
from repro_torch.configs.base import TrainConfig
from repro_torch.kernels.adamw import adamw as fused


class AdamWState(NamedTuple):
    m: dict
    v: dict
    count: int


@dataclass(frozen=True)
class LeafShard:
    """How one leaf lies on ``mesh``: the axes its block is split over, and
    the dim its moments split further over ``pod`` (ZeRO-1), if any. (Not a
    tuple: a tree holds it as one leaf.)"""
    mesh: object
    norm_axes: Tuple[str, ...] = ()
    zero1_dim: Optional[int] = None


def _zero1_view(t: torch.Tensor, sh: Optional[LeafShard]) -> torch.Tensor:
    """The rank's ``pod`` block of ``t`` on the leaf's ZeRO-1 dim (``t``
    itself without one)."""
    if sh is None or sh.zero1_dim is None:
        return t
    n, i = sh.mesh.shape["pod"], sh.mesh.coords["pod"]
    per = t.shape[sh.zero1_dim] // n
    return t.narrow(sh.zero1_dim, i * per, per)


def init(params, dtype=torch.bfloat16, shards=None) -> AdamWState:
    shards = shards if shards is not None else T.map(lambda p: None, params)

    def zeros():
        return T.map(lambda p, sh: torch.zeros(_zero1_view(p, sh).shape, dtype=dtype,
                                               device=p.device), params, shards)
    return AdamWState(m=zeros(), v=zeros(), count=0)


def _group_sums(sqs, leaf_shards) -> list:
    """The leaves' squares ``sqs`` summed per group of leaves split over the
    same axes, each group all-reduced over those axes, in sorted order of
    the axes (one order on every rank)."""
    groups: dict = {}
    for sq, sh in zip(sqs, leaf_shards):
        axes = sh.norm_axes if sh is not None else ()
        groups[axes] = groups[axes] + sq if axes in groups else sq
    parts = []
    for axes in sorted(groups):
        part = groups[axes]
        for a in axes:
            mesh = next(sh.mesh for sh in leaf_shards if sh is not None)
            part = collectives.all_reduce_sum(part, mesh, a, op="grad_norm")
        parts.append(part)
    return parts


def global_norm(tree, shards=None) -> torch.Tensor:
    """The norm of the logical tree. With ``shards``, the squares of the
    leaves split over the same axes are summed on each rank and all-reduced
    over those axes, one group at a time in one order on every rank."""
    sqs = [torch.sum(torch.square(g.to(torch.float32))) for g in T.leaves(tree)]
    if shards is None:
        return torch.sqrt(sum(sqs))
    total = None
    for part in _group_sums(sqs, T.leaves(shards)):
        total = part if total is None else total + part
    return torch.sqrt(total)


def _card_norm(grads: list, leaf_shards: list, max_norm: float):
    """``global_norm`` of the CUDA leaves ``grads`` and the clip's scale
    (None without a clip), both 0-d tensors on the card, with no host
    synchronisation: each leaf's sum of squares into its slot (the
    ``sumsq`` kernel), the slots grouped and all-reduced as ``global_norm``
    does, then one ``norm_scale`` launch."""
    slots = torch.empty(len(grads), dtype=torch.float32, device=grads[0].device)
    for i, g in enumerate(grads):
        fused.sumsq(g, slots[i])
    parts = slots
    if any(sh is not None for sh in leaf_shards):
        parts = torch.stack(_group_sums(list(slots), leaf_shards))
    out = fused.norm_scale(parts, max_norm)
    return out[0], (out[1] if max_norm > 0 else None)


def clip_by_global_norm(tree, max_norm: float, shards=None):
    """``tree`` scaled to a global norm of at most ``max_norm``, in place
    (the same products as scaled copies, without a second gradient in
    memory), and its norm before."""
    norm = global_norm(tree, shards)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    for g in T.leaves(tree):
        g.mul_(scale)
    return tree, norm


def _f32(x: float) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def update(grads, state: AdamWState, params, lr: float, cfg: TrainConfig, shards=None):
    """One AdamW step, in place. Returns (params, new_state, metrics).
    ``shards``: a tree of :class:`LeafShard` (or None) of ``params``'
    structure, for a sharded state.

    When every gradient is a CUDA tensor, the norm and the clip's scale stay
    on the card (:func:`_card_norm`) and each leaf takes one ``adamw_step``
    launch, which clips as it reads (the gradient is left as it was); the
    kernels raise on a leaf they do not take. Otherwise (the CPU) the
    gradients are clipped in place and every leaf takes
    :func:`_leaf_update`. ``kernels.adamw.route_leaves`` counts the leaves
    of each route."""
    grads = T.map(lambda g: g.to(torch.float32), grads)
    leaf_grads = T.leaves(grads)
    leaf_shards = T.leaves(shards) if shards is not None else [None] * len(leaf_grads)
    on_card = bool(leaf_grads) and all(g.is_cuda for g in leaf_grads)
    scale = None
    if on_card:
        gnorm, scale = _card_norm(leaf_grads, leaf_shards, cfg.grad_clip)
    elif cfg.grad_clip > 0:
        grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip, shards)
    else:
        gnorm = global_norm(grads, shards)
    count = state.count + 1
    b1, b2 = cfg.beta1, cfg.beta2
    c1 = float(1 - _f32(b1) ** _f32(count))
    c2 = float(1 - _f32(b2) ** _f32(count))
    with torch.no_grad():
        for p, g, m, v, sh in zip(T.leaves(params), leaf_grads, T.leaves(state.m),
                                  T.leaves(state.v), leaf_shards):
            pv, gv = _zero1_view(p, sh), _zero1_view(g, sh)
            if on_card:
                fused.adamw_step(pv, gv, m, v, scale, lr=lr, c1=c1, c2=c2, beta1=b1,
                                 beta2=b2, eps=cfg.eps, weight_decay=cfg.weight_decay)
                fused.route_leaves["kernel"] += 1
            else:
                _leaf_update(pv, gv, m, v, lr, c1, c2, cfg)
                fused.route_leaves["plain"] += 1
            if pv is not p:  # ZeRO-1: every pod rank's block into the parameter
                p.copy_(collectives.gather_dim(pv.contiguous(), sh.mesh, "pod", sh.zero1_dim,
                                               op="zero1_gather"))
    return params, AdamWState(m=state.m, v=state.v, count=count), {"grad_norm": gnorm}


def _leaf_update(pv, g, m, v, lr: float, c1: float, c2: float, cfg: TrainConfig) -> None:
    """One leaf's moments and parameter, in place. A function of its own, so
    that the leaf's float32 temporaries are freed before the next leaf's
    (a bank of experts is a few GiB of them)."""
    b1, b2 = cfg.beta1, cfg.beta2
    m.copy_(b1 * m.to(torch.float32) + (1 - b1) * g)
    v.copy_(b2 * v.to(torch.float32) + (1 - b2) * g * g)
    mm, vv = m.to(torch.float32), v.to(torch.float32)
    step = (mm / c1) / (torch.sqrt(vv / c2) + cfg.eps)
    pf = pv.to(torch.float32)
    pv.copy_(pf - lr * (step + cfg.weight_decay * pf))


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
