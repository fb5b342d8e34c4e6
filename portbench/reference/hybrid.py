"""Plain reference of the hybrid family (Hymba, arXiv:2411.13676): in every
layer an attention branch and a selective-SSM branch read the same normed
input, their outputs are each normed and averaged into the residual, then a
gated MLP. Sliding-window attention except in the configuration's global
layers. Written for this benchmark from the paper's and Mamba's equations
(arXiv:2312.00752, the diagonal selective scan); float32, TF32 off, no
kernels, no cache, no batching tricks.

SSM branch of input u (B, S, D), d_in = expand * D:
  xs, z = split(u W_in)                      (x and the gate)
  xs = silu(causal depthwise conv_K(xs) + b)  (zero history before p = 0)     
  dt_in, Bt, Ct = split(xs W_x)              (dt_rank, N, N)
  dt = softplus(dt_in W_dt + dt_bias); A = -exp(A_log)
  h_t = exp(dt_t A) h_{t-1} + dt_t xs_t Bt_t;  y_t = h_t . Ct_t + D xs_t
  out = (y * silu(z)) W_out
The scan runs in chunks: every chunk's local scan from a zero state at once,
then the state carried from chunk to chunk (the cumulative product of the
decays brings it forward), a different summation order from a one-step loop
and from any kernel, exact in real arithmetic.

Meta tokens and K/V groups, each off unless the configuration file names it:

``meta_tokens`` (M, default 0; the release's ``num_memory_tokens``): M learned
  vectors of width d_model, the leaf ``meta_tokens`` (M, D), put before every
  prompt and passed through every layer, in both branches (the paper's
  "meta tokens": prepended to the input sequence, which both heads read).
  Sequence position p counts them first: prompt token t is at p = M + t. A
  global layer's query at p sees every key k <= p; a window layer's sees
  k <= p where k < M or p - k < W (the paper: the sliding-window layers
  always attend the meta tokens). The conv history is zero before p = 0,
  and the SSM state after the prompt is h at p = M + S - 1. Logits are the
  last position's only; a prompt's tokens are its S positions, the meta
  positions are work.
``kv_groups`` (lists of layer indices, default []; the release's
  ``kv_reuse_group``): the first layer of a group computes K and V from its
  own normed input; each later layer of the group attends with those K and
  V and has no ``attn.wk.w`` or ``attn.wv.w`` (the paper's cross-layer K/V
  sharing between consecutive layers). Groups that overlap, a consumer
  before its owner and a group that mixes window and global layers are
  refused (``common.kv_owners``).

Assumed, as the paper's text does not state them: rotary angles at the
sequence position p, meta tokens counted (not at t); a consumer reads the
owner's rotated keys as they are; the meta vectors' initialisation (seeded
normals of scale 0.02, as the embedding's).

``prefill`` returns the last position's logits and what a cache must hold
after the prompt: on each layer that owns its K/V (a group's first layer or a
layer in no group) the rotated keys and the values of all M + S positions,
on a group's later layers none; on every layer the last SSM state (B, d_in,
N) and the conv history, the last K - 1 conv inputs (B, K - 1, d_in).
"""
from __future__ import annotations

import torch
from torch.nn import functional as F

from portbench.reference.common import (
    attention,
    gated_mlp,
    kv_owners,
    layer_windows,
    masked_logits,
    mm,
    rmsnorm,
    rope,
)

CHUNK = 64


def param_specs(cfg: dict) -> list:
    """(name, shape, init) of every parameter, in drawing order; ``init`` is
    ("normal", scale) | ("ones",) | ("zeros",) | ("a_log",) | ("dt_bias",).
    The meta tokens come last and draw from a stream of their own
    (``weights``), so that every other leaf draws what it draws without
    them; a K/V group's later layers have no ``wk``, ``wv``."""
    D, L, H, KH, hd = (cfg[k] for k in ("d_model", "num_layers", "num_heads", "num_kv_heads",
                                        "head_dim"))
    F_, Vp = cfg["d_ff"], cfg["vocab_padded"]
    s = cfg["ssm"]
    d_in, N, K, r = s["expand"] * D, s["state_dim"], s["conv_dim"], s["dt_rank"]
    lin = lambda n, a, b: (n, (a, b), ("normal", a ** -0.5))  # noqa: E731
    owners = kv_owners(cfg)
    specs = [("embed.table", (Vp, D), ("normal", 0.02))]
    for i in range(L):
        p = f"layers.{i}."
        kv = [lin(p + "attn.wk.w", D, KH * hd), lin(p + "attn.wv.w", D, KH * hd)]
        specs += [(p + "ln1.scale", (D,), ("ones",)), lin(p + "attn.wq.w", D, H * hd),
                  *(kv if owners[i] == i else []), lin(p + "attn.wo.w", H * hd, D),
                  lin(p + "ssm.in_proj.w", D, 2 * d_in),
                  (p + "ssm.conv_w", (K, d_in), ("normal", 0.2)),
                  (p + "ssm.conv_b", (d_in,), ("zeros",)),
                  lin(p + "ssm.x_proj.w", d_in, r + 2 * N), lin(p + "ssm.dt_proj.w", r, d_in),
                  (p + "ssm.dt_bias", (d_in,), ("dt_bias",)),
                  (p + "ssm.A_log", (d_in, N), ("a_log",)),
                  (p + "ssm.D", (d_in,), ("ones",)),
                  lin(p + "ssm.out_proj.w", d_in, D),
                  (p + "gn_attn.scale", (D,), ("ones",)), (p + "gn_ssm.scale", (D,), ("ones",)),
                  (p + "ln2.scale", (D,), ("ones",)),
                  lin(p + "mlp.up.w", D, F_), lin(p + "mlp.down.w", F_, D),
                  lin(p + "mlp.gate.w", D, F_)]
    specs += [("final_norm.scale", (D,), ("ones",)), lin("lm_head.w", D, Vp)]
    M = cfg.get("meta_tokens", 0)
    return specs + ([("meta_tokens", (M, D), ("normal", 0.02, 1))] if M else [])


def selective_scan(dt, x, Bm, Cm, A, D, h0, chunk: int = CHUNK):
    """dt, x (S, d) float32, Bm, Cm (S, N), A (d, N), D (d,), h0 (d, N) for
    one row -> y (S, d), h_S (d, N)."""
    S, d = dt.shape
    pad = (-S) % chunk  # padded steps decay by 1 and add 0: h is unchanged
    if pad:
        dt = F.pad(dt, (0, 0, 0, pad))
        x, Bm, Cm = (F.pad(t, (0, 0, 0, pad)) for t in (x, Bm, Cm))
    nc = dt.shape[0] // chunk
    a = torch.exp(dt[:, :, None] * A).view(nc, chunk, d, -1)
    h = ((dt * x)[:, :, None] * Bm[:, None, :]).view(nc, chunk, d, -1)
    for j in range(1, chunk):  # local scans from zero, all chunks at once
        h[:, j] += a[:, j] * h[:, j - 1]
        a[:, j] *= a[:, j - 1]  # the decay from the chunk's start
    carry = h0
    for c in range(nc):  # carry the state across chunks
        h[c] += a[c] * carry
        carry = h[c, -1]
    h = h.view(nc * chunk, d, -1)[:S]
    y = (h * Cm[:S, None, :]).sum(-1) + D * x[:S]
    return y, carry


def ssm_branch(w: dict, p: str, u: torch.Tensor, cfg: dict, precision: str):
    s = cfg["ssm"]
    N, K, r = s["state_dim"], s["conv_dim"], s["dt_rank"]
    xs, z = mm(u, w[p + "in_proj.w"], precision).chunk(2, dim=-1)
    S = xs.shape[1]
    xp = torch.cat([xs.new_zeros(xs.shape[0], K - 1, xs.shape[2]), xs], dim=1)
    conv = sum(xp[:, i:i + S] * w[p + "conv_w"][i] for i in range(K)) + w[p + "conv_b"]
    tail = xp[:, S:]  # the last K - 1 conv inputs
    xs = F.silu(conv)
    dt_in, Bm, Cm = mm(xs, w[p + "x_proj.w"], precision).split([r, N, N], dim=-1)
    dt = F.softplus(mm(dt_in, w[p + "dt_proj.w"], precision) + w[p + "dt_bias"])
    A = -torch.exp(w[p + "A_log"])
    ys, hs = [], []
    for b in range(xs.shape[0]):  # a row at a time: the scan's (S, d_in, N) fits
        h0 = xs.new_zeros(A.shape)
        y, h = selective_scan(dt[b], xs[b], Bm[b], Cm[b], A, w[p + "D"], h0)
        ys.append(y)
        hs.append(h)
    y = torch.stack(ys) * F.silu(z)
    return mm(y, w[p + "out_proj.w"], precision), torch.stack(hs), tail


@torch.no_grad()
def prefill(w: dict, cfg: dict, tokens: torch.Tensor, patches=None, *,
            precision: str = "fp32") -> dict:
    """tokens (B, S) -> {"logits": (B, vocab_padded) float32 at the last
    position, padded columns -1e30; "layers": per layer {"k", "v" (B, M + S,
    KH, hd) (k rotated; owners only), "ssm_h" (B, d_in, N), "ssm_conv"
    (B, K - 1, d_in)}}."""
    if patches is not None:
        raise ValueError("the hybrid family takes no patches")
    H, KH, hd, eps = cfg["num_heads"], cfg["num_kv_heads"], cfg["head_dim"], cfg["norm_eps"]
    M = cfg.get("meta_tokens", 0)
    owners, windows = kv_owners(cfg), layer_windows(cfg)
    B, S = tokens.shape
    x = w["embed.table"][tokens].float()
    if M:
        x = torch.cat([w["meta_tokens"].float().expand(B, M, -1), x], dim=1)
    n = M + S
    pos = torch.arange(n, device=tokens.device)
    layers, kv = [], {}
    for i in range(cfg["num_layers"]):
        p = f"layers.{i}."
        u = rmsnorm(x, w[p + "ln1.scale"], eps)
        q = rope(mm(u, w[p + "attn.wq.w"], precision).view(B, n, H, hd), pos, cfg["rope_theta"])
        if owners[i] == i:
            kv[i] = (rope(mm(u, w[p + "attn.wk.w"], precision).view(B, n, KH, hd), pos,
                          cfg["rope_theta"]),
                     mm(u, w[p + "attn.wv.w"], precision).view(B, n, KH, hd))
        k, v = kv[owners[i]]
        o = attention(q, k, v, window=windows[i], prefix=M, precision=precision)
        a = mm(o.reshape(B, n, H * hd), w[p + "attn.wo.w"], precision)
        s, h, tail = ssm_branch(w, p + "ssm.", u, cfg, precision)
        x = x + 0.5 * (rmsnorm(a, w[p + "gn_attn.scale"], eps)
                       + rmsnorm(s, w[p + "gn_ssm.scale"], eps))
        x = x + gated_mlp(rmsnorm(x, w[p + "ln2.scale"], eps), w[p + "mlp.gate.w"],
                          w[p + "mlp.up.w"], w[p + "mlp.down.w"], precision)
        own = {"k": k, "v": v} if owners[i] == i else {}
        layers.append(dict(own, ssm_h=h, ssm_conv=tail))
    last = rmsnorm(x[:, -1], w["final_norm.scale"], eps)
    logits = masked_logits(mm(last, w["lm_head.w"], precision), cfg["vocab_size"])
    return {"logits": logits, "layers": layers}
