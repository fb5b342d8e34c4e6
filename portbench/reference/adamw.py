"""Plain AdamW (Loshchilov and Hutter, arXiv:1711.05101) with global-norm
gradient clipping and a linear-warm-up, cosine-to-a-tenth learning rate,
written for this benchmark from those definitions.

The moments are kept in the dtype that the training configuration declares
for them (``moment_dtype``, bfloat16 here) and computed in float32; the
update is p <- p - lr (m_hat / (sqrt(v_hat) + eps) + wd p) on every leaf,
with m_hat = m / (1 - b1^t), v_hat = v / (1 - b2^t).
"""
from __future__ import annotations

import math

import torch


def learning_rate(opt: dict, step: int) -> float:
    """The rate of 0-based ``step``: warm-up (step + 1) / warmup_steps, then
    cosine decay from the peak to a tenth over the remaining steps."""
    warm = min((step + 1) / max(opt["warmup_steps"], 1), 1.0)
    prog = (step - opt["warmup_steps"]) / max(opt["total_steps"] - opt["warmup_steps"], 1)
    prog = min(max(prog, 0.0), 1.0)
    return opt["learning_rate"] * warm * (0.1 + 0.9 * 0.5 * (1 + math.cos(math.pi * prog)))


def global_norm(grads: dict) -> torch.Tensor:
    return torch.sqrt(sum(g.float().square().sum() for g in grads.values()))


@torch.no_grad()
def step(params: dict, grads: dict, moments: dict, opt: dict, count: int) -> torch.Tensor:
    """One AdamW step over every leaf, in place; ``moments`` holds ``m`` and
    ``v`` per leaf (made on the first call); ``count`` is the 1-based step.
    The gradients are clipped in place. Returns the norm before clipping."""
    norm = global_norm(grads)
    if opt["grad_clip"] > 0:
        scale = torch.clamp(opt["grad_clip"] / norm.clamp_min(1e-12), max=1.0)
        for g in grads.values():
            g.mul_(scale)
    dtype = getattr(torch, opt["moment_dtype"])
    b1, b2, eps, wd = opt["beta1"], opt["beta2"], opt["eps"], opt["weight_decay"]
    lr = learning_rate(opt, count - 1)
    c1, c2 = 1 - b1 ** count, 1 - b2 ** count
    for name, p in params.items():
        g = grads[name].float()
        m, v = moments.setdefault(name, (torch.zeros_like(p, dtype=dtype),
                                         torch.zeros_like(p, dtype=dtype)))
        m.copy_(b1 * m.float() + (1 - b1) * g)
        v.copy_(b2 * v.float() + (1 - b2) * g * g)
        upd = (m.float() / c1) / (torch.sqrt(v.float() / c2) + eps)
        p.sub_(lr * (upd + wd * p))
    return norm
