"""Plain reference of the hybrid family (Hymba, arXiv:2411.13676): in every
layer an attention branch and a selective-SSM branch read the same normed
input, their outputs are each normed and averaged into the residual, then a
gated MLP. Sliding-window attention except in the configuration's global
layers. Written for this benchmark from the paper's and Mamba's equations
(arXiv:2312.00752, the diagonal selective scan); float32, TF32 off, no
kernels, no cache, no batching tricks.

SSM branch of input u (B, S, D), d_in = expand * D:
  xs, z = split(u W_in)                      (x and the gate)
  xs = silu(causal depthwise conv_K(xs) + b)  (zero history before the prompt)
  dt_in, Bt, Ct = split(xs W_x)              (dt_rank, N, N)
  dt = softplus(dt_in W_dt + dt_bias); A = -exp(A_log)
  h_t = exp(dt_t A) h_{t-1} + dt_t xs_t Bt_t;  y_t = h_t . Ct_t + D xs_t
  out = (y * silu(z)) W_out
The scan runs in chunks: every chunk's local scan from a zero state at once,
then the state carried from chunk to chunk (the cumulative product of the
decays brings it forward), a different summation order from a one-step loop
and from any kernel, exact in real arithmetic.

``prefill`` returns the last position's logits and what a cache must hold
after the prompt: every layer's rotated keys and values of all S positions,
the last SSM state h_S (B, d_in, N) and the conv history, the last K - 1
conv inputs (B, K - 1, d_in).
"""
from __future__ import annotations

import torch
from torch.nn import functional as F

from portbench.reference.common import attention, gated_mlp, masked_logits, mm, rmsnorm, rope

CHUNK = 64


def param_specs(cfg: dict) -> list:
    """(name, shape, init) of every parameter, in drawing order; ``init`` is
    ("normal", scale) | ("ones",) | ("zeros",) | ("a_log",) | ("dt_bias",)."""
    D, L, H, KH, hd = (cfg[k] for k in ("d_model", "num_layers", "num_heads", "num_kv_heads",
                                        "head_dim"))
    F_, Vp = cfg["d_ff"], cfg["vocab_padded"]
    s = cfg["ssm"]
    d_in, N, K, r = s["expand"] * D, s["state_dim"], s["conv_dim"], s["dt_rank"]
    lin = lambda n, a, b: (n, (a, b), ("normal", a ** -0.5))  # noqa: E731
    specs = [("embed.table", (Vp, D), ("normal", 0.02))]
    for i in range(L):
        p = f"layers.{i}."
        specs += [(p + "ln1.scale", (D,), ("ones",)),
                  lin(p + "attn.wq.w", D, H * hd), lin(p + "attn.wk.w", D, KH * hd),
                  lin(p + "attn.wv.w", D, KH * hd), lin(p + "attn.wo.w", H * hd, D),
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
    return specs


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
    position, padded columns -1e30; "layers": per layer {"k", "v" (B, S, KH,
    hd) (k rotated), "ssm_h" (B, d_in, N), "ssm_conv" (B, K - 1, d_in)}}."""
    if patches is not None:
        raise ValueError("the hybrid family takes no patches")
    H, KH, hd, eps = cfg["num_heads"], cfg["num_kv_heads"], cfg["head_dim"], cfg["norm_eps"]
    B, S = tokens.shape
    pos = torch.arange(S, device=tokens.device)
    x = w["embed.table"][tokens].float()
    layers = []
    for i in range(cfg["num_layers"]):
        p = f"layers.{i}."
        u = rmsnorm(x, w[p + "ln1.scale"], eps)
        q = rope(mm(u, w[p + "attn.wq.w"], precision).view(B, S, H, hd), pos, cfg["rope_theta"])
        k = rope(mm(u, w[p + "attn.wk.w"], precision).view(B, S, KH, hd), pos,
                 cfg["rope_theta"])
        v = mm(u, w[p + "attn.wv.w"], precision).view(B, S, KH, hd)
        window = None if i in cfg["global_layers"] else cfg["sliding_window"]
        o = attention(q, k, v, window=window, precision=precision)
        a = mm(o.reshape(B, S, H * hd), w[p + "attn.wo.w"], precision)
        s, h, tail = ssm_branch(w, p + "ssm.", u, cfg, precision)
        x = x + 0.5 * (rmsnorm(a, w[p + "gn_attn.scale"], eps)
                       + rmsnorm(s, w[p + "gn_ssm.scale"], eps))
        x = x + gated_mlp(rmsnorm(x, w[p + "ln2.scale"], eps), w[p + "mlp.gate.w"],
                          w[p + "mlp.up.w"], w[p + "mlp.down.w"], precision)
        layers.append({"k": k, "v": v, "ssm_h": h, "ssm_conv": tail})
    last = rmsnorm(x[:, -1], w["final_norm.scale"], eps)
    logits = masked_logits(mm(last, w["lm_head.w"], precision), cfg["vocab_size"])
    return {"logits": logits, "layers": layers}

