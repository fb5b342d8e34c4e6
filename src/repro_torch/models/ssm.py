"""Selective state-space (mamba-style) core of hymba's SSM branch, in PyTorch.

The counterpart of ``src/repro/models/ssm.py``. Diagonal SSM:
``h_t = exp(dt_t * A) h_{t-1} + dt_t * B_t x_t``, ``y_t = C_t . h_t + D x_t``,
computed chunk by chunk with the carried state passed from one chunk to the
next. Each chunk's scan is a Select named after the reference's ``impl``
argument (which the reference never reads):

``pallas``  the slot of the reference's TPU scan kernel; here it is the
            hand-written Hopper kernel (``repro_torch.kernels.ssm_scan``),
            and its plain version on CPU tensors. The port's default.
``jnp``     the plain PyTorch version of the same chunk scan, so that the
            kernel can be held to it on the card.

Cast points are the reference's: the projections multiply in bfloat16, the
causal conv multiplies and sums its taps in bfloat16, dt, a, bx, the state
and the contraction with C are float32. ``SSMState.conv`` starts as float32
(``init_state``) and comes back in the activations' bfloat16.

Parameter names follow the reference's tree (``in_proj.w``, ``conv_w``,
``conv_b``, ``x_proj.w``, ``dt_proj.w``, ``dt_bias``, ``A_log``, ``D``,
``out_proj.w``) so that ``convert.params_from_reference`` fills them by name.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn
from torch.nn import functional as F

from repro_torch.configs.base import SSMConfig
from repro_torch.kernels.ssm_scan.ssm_scan import ssm_scan_chunk, ssm_scan_chunk_ref
from repro_torch.models.layers import Linear, _param, truncated_normal_

#: the chunk scan by ``impl`` name
SCANS = {"jnp": ssm_scan_chunk_ref, "pallas": ssm_scan_chunk}


def dt_rank(d_model: int, s: SSMConfig) -> int:
    return s.dt_rank or max(1, -(-d_model // 16))


class SSM(nn.Module):
    """The SSM branch's parameters, float32, drawn by :meth:`init` from the
    reference's distributions (``ssm_init``)."""

    def __init__(self, d_model: int, s: SSMConfig, device=None):
        super().__init__()
        d_in, r = s.expand * d_model, dt_rank(d_model, s)
        self.in_proj = Linear(d_model, 2 * d_in, device=device)  # x and gate z
        self.conv_w = _param((s.conv_dim, d_in), device)
        self.conv_b = _param((d_in,), device)
        self.x_proj = Linear(d_in, r + 2 * s.state_dim, device=device)  # dt, B, C
        self.dt_proj = Linear(r, d_in, device=device)
        self.dt_bias = _param((d_in,), device)
        self.A_log = _param((d_in, s.state_dim), device)
        self.D = _param((d_in,), device)
        self.out_proj = Linear(d_in, d_model, device=device)

    @torch.no_grad()
    def init(self, gen: torch.Generator) -> None:
        d_in, n = self.A_log.shape
        self.in_proj.init(gen)
        truncated_normal_(self.conv_w, 0.2, gen)
        self.conv_b.zero_()
        self.x_proj.init(gen)
        self.dt_proj.init(gen)
        # the inverse softplus of dt ~ U(1e-3, 1e-1)
        dt = torch.rand(d_in, generator=gen, device=self.dt_bias.device) * (1e-1 - 1e-3) + 1e-3
        self.dt_bias.copy_(torch.log(torch.exp(dt) - 1.0))
        # S4D-real initialisation of A (negative reals)
        self.A_log.copy_(torch.log(torch.arange(1, n + 1, dtype=torch.float32)).expand(d_in, n))
        self.D.fill_(1.0)
        self.out_proj.init(gen)


class SSMState(NamedTuple):
    h: torch.Tensor  # (B, d_in, N) carried SSM state, float32
    conv: torch.Tensor  # (B, conv_dim - 1, d_in) causal-conv tail


def init_state(batch: int, d_model: int, s: SSMConfig, dtype=torch.float32,
               device=None) -> SSMState:
    d_in = s.expand * d_model
    return SSMState(h=torch.zeros((batch, d_in, s.state_dim), dtype=dtype, device=device),
                    conv=torch.zeros((batch, s.conv_dim - 1, d_in), dtype=dtype, device=device))


def _causal_conv(x, w, b, tail):
    """x: (B, S, C), w: (K, C) depthwise, tail: (B, K-1, C) from the previous
    segment. Taps multiplied and summed in x's dtype, in order i = 0..K-1."""
    K, S = w.shape[0], x.shape[1]
    xp = torch.cat([tail.to(x.dtype), x], dim=1)
    w = w.to(x.dtype)
    out = xp[:, :S] * w[0]
    for i in range(1, K):
        out = out + xp[:, i:i + S] * w[i]
    # a copy, so that the cache does not hold the whole padded input alive
    new_tail = xp[:, S:].clone() if K > 1 else torch.zeros_like(tail)
    return out + b.to(x.dtype), new_tail


def ssm_apply(p: SSM, x: torch.Tensor, s: SSMConfig, state: Optional[SSMState] = None, *,
              chunk: int = 256, impl: str = "pallas"):
    """x (B, S, D) bfloat16 -> (y (B, S, D), new state). The sequence is
    padded to whole chunks with a = 1 and bx = 0, so the carried state is
    the one at the last real token."""
    if impl not in SCANS:
        raise ValueError(f"unknown SSM scan impl {impl!r}; known: {sorted(SCANS)}")
    scan = SCANS[impl]
    B, S, D = x.shape
    N = s.state_dim
    state = state if state is not None else init_state(B, D, s, device=x.device)

    xs, z = p.in_proj(x).chunk(2, dim=-1)  # (B, S, d_in) each
    xs, conv_tail = _causal_conv(xs, p.conv_w, p.conv_b, state.conv)
    xs = F.silu(xs)
    dt_in, Bmat, Cmat = p.x_proj(xs).split([dt_rank(D, s), N, N], dim=-1)
    dt = F.softplus(p.dt_proj(dt_in).float() + p.dt_bias)  # (B, S, d_in)
    A = -torch.exp(p.A_log)  # (d_in, N)
    a = (dt[..., None] * A).exp_()  # (B, S, d_in, N)
    bx = (dt * xs.float())[..., None] * Bmat.float()[..., None, :]

    pad = (-S) % chunk
    if pad:
        a = F.pad(a, (0, 0, 0, 0, 0, pad), value=1.0)
        bx = F.pad(bx, (0, 0, 0, 0, 0, pad))
        Cmat = F.pad(Cmat, (0, 0, 0, pad))
    Cf = Cmat.float()
    h = state.h.float()
    ys = []
    for start in range(0, S + pad, chunk):
        # a chunk of a and bx is a view: the kernel reads it through its
        # batch stride. Contracting with C inside the chunk keeps the state
        # sequence to one chunk at a time.
        h_seq, h = scan(a[:, start:start + chunk], bx[:, start:start + chunk], h)
        ys.append(torch.einsum("bcdn,bcn->bcd", h_seq, Cf[:, start:start + chunk]))
    y = torch.cat(ys, dim=1)[:, :S] + p.D * xs.float()
    y = y.to(x.dtype) * F.silu(z)
    return p.out_proj(y), SSMState(h=h, conv=conv_tail)


def ssm_decode(p: SSM, x: torch.Tensor, s: SSMConfig, state: SSMState, *,
               impl: str = "pallas"):
    """Single-token recurrence. x: (B, 1, D)."""
    return ssm_apply(p, x, s, state, chunk=1, impl=impl)
