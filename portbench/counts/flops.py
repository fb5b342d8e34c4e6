"""Forward FLOPs of the token-stack families (dense, vlm, hybrid), on a
configuration file's numbers. Derived from
``repro_torch.analysis.flops.fwd_flops_layerwise`` and frozen here, with two
changes: attention's scores and values are counted over the (query, key)
pairs that the causal and window masks leave (``kernels.attention_pairs``),
where the original counts the full S_kv that a chunked implementation walks;
and the selective scan is counted as ``kernels.selective_scan`` counts it.
So the whole step's share of the peak counts only the work a prompt needs,
and reads no higher than the kernels' rooflines allow.

A configuration's meta tokens (``meta_tokens``, M) are work: every layer is
counted over M + S positions, the window layers' attention over the pairs
that a prefix of M leaves. A K/V group's later layers (``kv_groups``) project
no K and V. A prefill's head is counted over the last position only, a
training forward's head over every prompt position, as in the original.
"""
from __future__ import annotations

from typing import Optional

from portbench.counts.kernels import attention_pairs, selective_scan
from portbench.reference.common import kv_owners, layer_windows


def _attn_fwd(batch: int, seq: int, H, KH, hd, D, window: Optional[int], prefix: int,
              owns_kv: bool):
    T = batch * seq
    proj = 2 * T * D * (H + (2 * KH if owns_kv else 0)) * hd + 2 * T * H * hd * D
    scores = 4 * batch * H * hd * attention_pairs(seq, seq, True, window, prefix)
    return proj + scores


def _mlp_fwd(T, D, F, gated: bool = True):
    return (6 if gated else 4) * T * D * F


def _ssm_fwd(batch: int, seq: int, cfg: dict):
    s, D, T = cfg["ssm"], cfg["d_model"], batch * seq
    d_in, dtr, N = s["expand"] * D, s["dt_rank"], s["state_dim"]
    proj = 2 * T * D * 2 * d_in + 2 * T * d_in * (dtr + 2 * N) + 2 * T * dtr * d_in \
        + 2 * T * d_in * D
    conv = 2 * T * s["conv_dim"] * d_in
    scan = selective_scan(batch, seq, d_in, N, cfg["dtypes"])[0]
    return proj + conv + scan


def fwd_flops(cfg: dict, batch: int, seq: int, kind: str) -> float:
    """The forward FLOPs of one batch of ``batch`` x ``seq`` tokens, ``kind``
    "prefill" or "train": the layers' over the meta tokens and the tokens,
    plus the head's."""
    if kind not in ("prefill", "train"):
        raise ValueError(f"kind {kind!r}: 'prefill' or 'train'")
    family = cfg["family"]
    if family not in ("dense", "vlm", "hybrid"):
        raise ValueError(f"no frozen count for the {family} family")
    D, V, hd = cfg["d_model"], cfg["vocab_size"], cfg["head_dim"]
    H, KH, F, L = cfg["num_heads"], cfg["num_kv_heads"], cfg["d_ff"], cfg["num_layers"]
    M = cfg.get("meta_tokens", 0)
    n = M + seq
    attn = sum(_attn_fwd(batch, n, H, KH, hd, D, w, M, owner == i)
               for i, (w, owner) in enumerate(zip(layer_windows(cfg), kv_owners(cfg))))
    ffn = L * _mlp_fwd(batch * n, D, F, cfg["mlp_gated"])
    ssm = L * _ssm_fwd(batch, n, cfg) if family == "hybrid" else 0.0
    head = 2 * batch * seq * D * V if kind == "train" else 2 * batch * D * V
    return float(attn + ffn + ssm + head)
