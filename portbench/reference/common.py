"""Plain building blocks of the reference models, in float32 with TF32 off.

Written for this benchmark from the published layer equations (RMSNorm,
rotary embedding on split halves, causal and windowed softmax attention with
grouped KV heads and a prefix that every query sees, gated MLP,
cross-entropy); it imports nothing of the program under test and takes
nothing the program made.

Every matrix product goes through :func:`mm`, so that one switch moves the
whole reference to another precision. ``"fp32"`` is the reference itself.
``"fp8"`` is the benchmark's control: both operands of every product rounded
to float8 e4m3 (per-tensor scale, amax over 448) and multiplied in float32,
in backward too (the cotangent rounded the same way). That is the precision
one step below the bfloat16 that the configurations state for their
products, so a program computing there must fail the comparison.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

PRECISIONS = ("fp32", "fp8")
NEG_INF = -1e30
E4M3_MAX = 448.0


def no_tf32() -> None:
    """Full float32 products: the reference never runs in TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under a per-tensor scale, back in float32."""
    x = x.float()
    scale = x.detach().abs().amax().clamp_min(1e-30) / E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


class _Fp8Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        aq, bq = fp8_round(a), fp8_round(b)
        ctx.save_for_backward(aq, bq)
        return aq @ bq

    @staticmethod
    def backward(ctx, g):
        aq, bq = ctx.saved_tensors
        gq = fp8_round(g)
        da = gq @ bq.transpose(-1, -2)
        db = aq.transpose(-1, -2) @ gq
        # a broadcast operand (a weight against a batch) sums its cotangent
        while db.dim() > bq.dim():
            db = db.sum(0)
        return da, db


def mm(a: torch.Tensor, b: torch.Tensor, precision: str = "fp32") -> torch.Tensor:
    """``a @ b`` in float32, or with both operands in fp8 (the control)."""
    if precision == "fp32":
        return a.float() @ b.float()
    if precision == "fp8":
        return _Fp8Matmul.apply(a.float(), b.float())
    raise ValueError(f"unknown precision {precision!r}; known: {PRECISIONS}")


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    x = x.float()
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding of x (B, S, H, hd) on split halves (the first half
    pairs with the second), angles pos * theta^(-2i/hd)."""
    hd = x.shape[-1]
    inv = theta ** (-torch.arange(0, hd, 2, dtype=torch.float64, device=x.device) / hd)
    ang = (positions.double()[:, None] * inv).float()  # (S, hd/2)
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              window: Optional[int] = None, prefix: int = 0, block: int = 512,
              precision: str = "fp32") -> torch.Tensor:
    """Causal softmax attention, q (B, S, H, hd), k and v (B, S, KH, hd); query
    head h reads KV head h // (H / KH). ``window``: a query at p sees keys
    p - window < k <= p. ``prefix``: keys k < prefix are seen by every query
    at or after them, window or not (Hymba's meta tokens). Computed a block of
    queries at a time, over only the keys the block can see: ``[0, prefix)``
    and the block's own window."""
    B, S, H, hd = q.shape
    KH = k.shape[2]
    group = H // KH
    qh = q.float().transpose(1, 2)  # (B, H, S, hd)
    kh = k.float().transpose(1, 2).repeat_interleave(group, dim=1)
    vh = v.float().transpose(1, 2).repeat_interleave(group, dim=1)
    out = []
    for q0 in range(0, S, block):
        q1 = min(q0 + block, S)
        k0 = 0 if window is None else max(0, q0 - window + 1)
        pre = min(prefix, k0)  # prefix keys left of the block's window
        qp = torch.arange(q0, q1, device=q.device)[:, None]
        kp = torch.arange(k0, q1, device=q.device)[None, :]
        kb, vb = kh[:, :, k0:q1], vh[:, :, k0:q1]
        if pre:
            kp = torch.cat([torch.arange(pre, device=q.device)[None, :], kp], dim=1)
            kb = torch.cat([kh[:, :, :pre], kb], dim=2)
            vb = torch.cat([vh[:, :, :pre], vb], dim=2)
        ok = kp <= qp
        if window is not None:
            ok = ok & ((qp - kp < window) | (kp < prefix))
        s = mm(qh[:, :, q0:q1], kb.transpose(-1, -2), precision) / math.sqrt(hd)
        s = s.masked_fill(~ok, NEG_INF)
        out.append(mm(torch.softmax(s, dim=-1), vb, precision))
    return torch.cat(out, dim=2).transpose(1, 2)  # (B, S, H, hd)


def layer_windows(cfg: dict) -> list:
    """Each layer's attention window: None for global attention."""
    W, glob = cfg.get("sliding_window"), set(cfg.get("global_layers", []))
    return [None if W is None or i in glob else W for i in range(cfg["num_layers"])]


def kv_owners(cfg: dict) -> list:
    """Each layer's K/V owner under the configuration's ``kv_groups`` (Hymba's
    ``kv_reuse_group``): the group's first layer for its later members, the
    layer itself otherwise. Raises on groups that overlap or leave the model,
    on a consumer before its owner, and on a group that mixes window and
    global layers."""
    L, windows = cfg["num_layers"], layer_windows(cfg)
    owners = list(range(L))
    seen = set()
    for g in cfg.get("kv_groups", []):
        g = [int(i) for i in g]
        if not g or any(not 0 <= i < L for i in g):
            raise ValueError(f"kv group {g}: empty or outside layers 0..{L - 1}")
        if seen & set(g) or len(set(g)) != len(g):
            raise ValueError(f"kv group {g} overlaps another group or itself")
        if any(i < g[0] for i in g[1:]):
            raise ValueError(f"kv group {g}: a consumer comes before its owner {g[0]}")
        if len({windows[i] for i in g}) != 1:
            raise ValueError(f"kv group {g} mixes window and global layers")
        seen |= set(g)
        for i in g[1:]:
            owners[i] = g[0]
    return owners


def gated_mlp(x: torch.Tensor, w_gate, w_up, w_down, precision: str = "fp32") -> torch.Tensor:
    g = mm(x, w_gate, precision)
    return mm(torch.nn.functional.silu(g) * mm(x, w_up, precision), w_down, precision)


def masked_logits(logits: torch.Tensor, vocab: int) -> torch.Tensor:
    """Columns at and past ``vocab`` (the table's padding) at -1e30."""
    if logits.shape[-1] == vocab:
        return logits
    cols = torch.arange(logits.shape[-1], device=logits.device)
    return logits.masked_fill(cols >= vocab, NEG_INF)


def cross_entropy_sum(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """The summed next-token cross-entropy of float32 logits (..., V)."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return (logz - gold).sum()
