"""Plain reference of the vlm family (Phi-3-vision's language model): a
pre-norm decoder with grouped-query attention, rotary embedding and a gated
SiLU MLP, whose first P input positions are the vision frontend's patch
embeddings in place of token embeddings. Written for this benchmark from the
Llama/Phi-3 layer equations; float32, TF32 off, no kernels and no cache.

``loss`` is the mean next-token cross-entropy over every position of the
batch (patch positions included, as their labels are given), each layer
recomputed in backward (``torch.utils.checkpoint``) so that a 3.8 B model's
float32 step fits beside its state. ``prefill`` gives the last position's
logits and every layer's rotated keys and values.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from portbench.reference.common import (
    attention,
    cross_entropy_sum,
    gated_mlp,
    masked_logits,
    mm,
    rmsnorm,
    rope,
)

#: positions of the loss computed at a time (its float32 logits are
#: (B, LOSS_CHUNK, vocab))
LOSS_CHUNK = 256


def param_specs(cfg: dict) -> list:
    """(name, shape, init) of every parameter, in drawing order (see
    ``hybrid.param_specs``)."""
    D, L, H, KH, hd = (cfg[k] for k in ("d_model", "num_layers", "num_heads", "num_kv_heads",
                                        "head_dim"))
    F_, Vp = cfg["d_ff"], cfg["vocab_padded"]
    lin = lambda n, a, b: (n, (a, b), ("normal", a ** -0.5))  # noqa: E731
    specs = [("embed.table", (Vp, D), ("normal", 0.02))]
    for i in range(L):
        p = f"layers.{i}."
        specs += [(p + "ln1.scale", (D,), ("ones",)),
                  lin(p + "attn.wq.w", D, H * hd), lin(p + "attn.wk.w", D, KH * hd),
                  lin(p + "attn.wv.w", D, KH * hd), lin(p + "attn.wo.w", H * hd, D),
                  (p + "ln2.scale", (D,), ("ones",)),
                  lin(p + "mlp.up.w", D, F_), lin(p + "mlp.down.w", F_, D),
                  lin(p + "mlp.gate.w", D, F_)]
    specs += [("final_norm.scale", (D,), ("ones",)), lin("lm_head.w", D, Vp)]
    return specs


def embed(w: dict, tokens: torch.Tensor, patches=None) -> torch.Tensor:
    x = w["embed.table"][tokens].float()
    if patches is not None:
        P = patches.shape[1]
        x = torch.cat([patches.float(), x[:, P:]], dim=1)
    return x


def _layer(x, w, p, cfg, pos, precision, kv=None):
    B, S, _ = x.shape
    H, KH, hd, eps = cfg["num_heads"], cfg["num_kv_heads"], cfg["head_dim"], cfg["norm_eps"]
    u = rmsnorm(x, w[p + "ln1.scale"], eps)
    q = rope(mm(u, w[p + "attn.wq.w"], precision).view(B, S, H, hd), pos, cfg["rope_theta"])
    k = rope(mm(u, w[p + "attn.wk.w"], precision).view(B, S, KH, hd), pos, cfg["rope_theta"])
    v = mm(u, w[p + "attn.wv.w"], precision).view(B, S, KH, hd)
    if kv is not None:
        kv.append({"k": k, "v": v})
    o = attention(q, k, v, window=cfg.get("sliding_window"), precision=precision)
    x = x + mm(o.reshape(B, S, H * hd), w[p + "attn.wo.w"], precision)
    return x + gated_mlp(rmsnorm(x, w[p + "ln2.scale"], eps), w[p + "mlp.gate.w"],
                         w[p + "mlp.up.w"], w[p + "mlp.down.w"], precision)


def _loss_chunk(h, head, labels, vocab, precision):
    return cross_entropy_sum(masked_logits(mm(h, head, precision), vocab), labels)


def loss(w: dict, cfg: dict, batch: dict, *, precision: str = "fp32") -> torch.Tensor:
    """The mean cross-entropy of ``batch`` (tokens, labels (B, S); patches
    (B, P, D)), differentiable in ``w``."""
    tokens, labels = batch["tokens"], batch["labels"]
    B, S = tokens.shape
    pos = torch.arange(S, device=tokens.device)
    x = embed(w, tokens, batch.get("patches"))
    for i in range(cfg["num_layers"]):
        p = f"layers.{i}."
        names = [n for n in w if n.startswith(p)]
        x = checkpoint(lambda x, *ts, p=p, names=names: _layer(
            x, dict(zip(names, ts)), p, cfg, pos, precision), x, *(w[n] for n in names),
            use_reentrant=False)
    h = rmsnorm(x, w["final_norm.scale"], cfg["norm_eps"])
    total = h.new_zeros(())
    for c in range(0, S, LOSS_CHUNK):
        total = total + checkpoint(_loss_chunk, h[:, c:c + LOSS_CHUNK], w["lm_head.w"],
                                   labels[:, c:c + LOSS_CHUNK], cfg["vocab_size"], precision,
                                   use_reentrant=False)
    return total / (B * S)


@torch.no_grad()
def prefill(w: dict, cfg: dict, tokens: torch.Tensor, patches=None, *,
            precision: str = "fp32") -> dict:
    """tokens (B, S), patches (B, P, D) -> {"logits": (B, vocab_padded) at
    the last position, "layers": per layer {"k", "v" (B, S, KH, hd)}}."""
    S = tokens.shape[1]
    pos = torch.arange(S, device=tokens.device)
    x = embed(w, tokens, patches)
    layers: list = []
    for i in range(cfg["num_layers"]):
        x = _layer(x, w, f"layers.{i}.", cfg, pos, precision, kv=layers)
    last = rmsnorm(x[:, -1], w["final_norm.scale"], cfg["norm_eps"])
    return {"logits": masked_logits(mm(last, w["lm_head.w"], precision), cfg["vocab_size"]),
            "layers": layers}
