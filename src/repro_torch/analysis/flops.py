"""Analytic FLOP/byte accounting for the implemented step functions.

The counterpart of ``src/repro/analysis/flops.py``: the same arithmetic on
``repro_torch.configs``, number for number (``tests/test_torch_analysis.py``
holds every arch x shape x mesh to the reference's).

Why analytic: a step's cost must be known for the production meshes, which
no one host can run. ``torch.utils.flop_counter.FlopCounterMode`` counts
the products a forward really runs (``launch.dryrun`` records that count
beside this one, and ``tests/test_torch_analysis.py`` holds the two within
15% on an unrolled forward and 25% on forward plus backward), but it does
not see the ctypes-launched Hopper kernels, and it counts no bytes. So the
roofline (``analysis.roofline``) reads FLOPs and HBM bytes from here:
matmul-exact and implementation-faithful.

Implementation-faithful means: chunked attention computes FULL S_kv with
masking (2x the causal-optimal attention FLOPs), MoE counts capacity
padding, remat recomputes the layer forward. The port's default
``attn_impl="xla_chunked"`` (``models.attention.attention_chunked``) does
the same: it walks every KV chunk of the full S_kv and masks, so the model
holds for it. The ``"pallas"`` slot (the Hopper flash-attention kernel)
skips wholly masked tiles and so does less than this model counts.

MODEL_FLOPS is the usual 6·N·D (dense) / 6·N_active·D (MoE) useful-work figure;
the ratio MODEL_FLOPS / implementation FLOPs exposes remat + masking +
capacity waste.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.configs.base import ModelConfig, ShapeConfig


@dataclass
class StepCost:
    flops: float  # total across the job, per step
    bytes_hbm: float  # total HBM traffic across the job, per step
    model_flops: float  # 6*N*D useful-work reference
    params: float  # trained parameter count
    notes: str = ""


def param_count(cfg: ModelConfig) -> float:
    D, V, hd = cfg.d_model, cfg.vocab_size, cfg.head_dim_
    H, KH, F, L = cfg.num_heads, cfg.num_kv_heads, cfg.d_ff, cfg.num_layers
    if cfg.family == "ssm":  # xlstm
        n_s = sum(1 for i in range(L) if (i % (cfg.xlstm.slstm_every)) == cfg.xlstm.slstm_every - 1)
        n_m = L - n_s
        mlstm = D * H * hd * 3 + D * H * 2 + D * H * hd + H * hd * D
        f_up = int(D * 4 / 3)
        slstm = 4 * D * D + 4 * D + 3 * D * f_up
        return V * D + n_m * mlstm + n_s * slstm + D * V
    attn = D * (H + 2 * KH) * hd + H * hd * D
    n_mats = 3 if cfg.mlp_gated else 2
    if cfg.family == "moe":
        m = cfg.moe
        ffn = D * m.num_experts + 3 * m.num_experts * D * m.d_ff_expert
    else:
        ffn = n_mats * D * F
    layer = attn + ffn
    if cfg.family == "hybrid":
        s = cfg.ssm
        d_in = s.expand * D
        dtr = s.dt_rank or max(1, -(-D // 16))
        ssm_p = (D * 2 * d_in + s.conv_dim * d_in + d_in * (dtr + 2 * s.state_dim)
                 + dtr * d_in + d_in * s.state_dim + d_in + d_in * D)
        layer = attn + ffn + ssm_p
    total = V * D + L * layer + (0 if cfg.tie_embeddings else D * V)
    if cfg.family == "audio":
        e = cfg.encdec
        enc_layer = attn + ffn
        dec_layer = 2 * attn + ffn
        total = V * D + e.enc_layers * enc_layer + e.dec_layers * dec_layer + D * V
    return float(total)


def active_param_count(cfg: ModelConfig) -> float:
    if cfg.family != "moe":
        return param_count(cfg)
    D, V, hd = cfg.d_model, cfg.vocab_size, cfg.head_dim_
    H, KH, L = cfg.num_heads, cfg.num_kv_heads, cfg.num_layers
    m = cfg.moe
    attn = D * (H + 2 * KH) * hd + H * hd * D
    ffn_active = D * m.num_experts + 3 * m.top_k * D * m.d_ff_expert
    return float(V * D + L * (attn + ffn_active) + D * V)


# ---------------------------------------------------------------------------
# per-component forward FLOPs (total across the job)
# ---------------------------------------------------------------------------


def _attn_fwd(T, S_kv, H, KH, hd, D, qkv_bias=False):
    proj = 2 * T * D * (H + 2 * KH) * hd + 2 * T * H * hd * D
    scores = 4 * T * S_kv * H * hd  # QK^T + PV, full-S_kv masked (impl-faithful)
    return proj + scores


def _mlp_fwd(T, D, F, gated: bool = True):
    return (6 if gated else 4) * T * D * F


def _moe_fwd(T, cfg: ModelConfig):
    import math

    m = cfg.moe
    D = cfg.d_model
    C = max(1, math.ceil(T * m.top_k * m.capacity_factor / m.num_experts))
    router = 2 * T * D * m.num_experts
    experts = 6 * (m.num_experts * C) * D * m.d_ff_expert  # capacity padding counted
    return router + experts


def _ssm_fwd(T, cfg: ModelConfig):
    s = cfg.ssm
    D = cfg.d_model
    d_in = s.expand * D
    dtr = s.dt_rank or max(1, -(-D // 16))
    proj = 2 * T * D * 2 * d_in + 2 * T * d_in * (dtr + 2 * s.state_dim) \
        + 2 * T * dtr * d_in + 2 * T * d_in * D
    conv = 2 * T * s.conv_dim * d_in
    scan = 12 * T * d_in * s.state_dim  # discretize + assoc-scan + C.h
    return proj + conv + scan


def _mlstm_fwd(T, cfg: ModelConfig):
    D, H, hd = cfg.d_model, cfg.num_heads, cfg.head_dim_
    C = cfg.xlstm.chunk_size if cfg.xlstm else 64
    proj = 2 * T * D * (3 * H * hd + 2 * H + H * hd) + 2 * T * H * hd * D
    intra = 4 * T * C * H * hd  # scores + h_intra within chunk
    inter = 6 * T * H * hd * hd  # q.C0, C1 update, n updates
    return proj + intra + inter


def _slstm_fwd(T, cfg: ModelConfig):
    D = cfg.d_model
    f_up = int(D * 4 / 3)
    return 8 * T * D * D + 25 * T * D + 6 * T * D * f_up


def fwd_flops_layerwise(cfg: ModelConfig, shape: ShapeConfig, kind: str):
    """(layers_fwd, head_fwd) total-job forward FLOPs.

    kind: 'train'/'prefill' (full sequence) or 'decode' (one token vs cache).
    """
    B, S = shape.global_batch, shape.seq_len
    D, V, hd = cfg.d_model, cfg.vocab_size, cfg.head_dim_
    H, KH, F, L = cfg.num_heads, cfg.num_kv_heads, cfg.d_ff, cfg.num_layers

    if kind == "decode":
        T, S_kv = B, S  # one new token, cache of S
    else:
        T, S_kv = B * S, S

    if cfg.family == "ssm":
        every = cfg.xlstm.slstm_every
        n_s = sum(1 for i in range(L) if (i % every) == every - 1)
        n_m = L - n_s
        if kind == "decode":
            layers = n_m * (_mlstm_fwd(T, cfg)) + n_s * _slstm_fwd(T, cfg)
        else:
            layers = n_m * _mlstm_fwd(T, cfg) + n_s * _slstm_fwd(T, cfg)
        head = 2 * T * D * V if kind == "train" else 2 * B * D * V
        return layers, head

    if cfg.family == "audio":
        e = cfg.encdec
        S_src = max(1, S // e.src_ratio)
        T_src = B * S_src
        if kind == "decode":
            T_dec, S_self, enc_T = B, S, 0  # encoder already cached
            enc = 0.0
        else:
            T_dec, S_self = B * S, S
            enc = e.enc_layers * (_attn_fwd(T_src, S_src, H, KH, hd, D) + _mlp_fwd(T_src, D, F))
        self_attn = _attn_fwd(T_dec, S_self, H, KH, hd, D)
        cross_q = 2 * T_dec * D * H * hd + 2 * T_dec * H * hd * D
        cross_kv = 0 if kind == "decode" else 2 * T_src * D * 2 * KH * hd
        cross_scores = 4 * T_dec * S_src * H * hd
        dec = e.dec_layers * (self_attn + cross_q + cross_kv + cross_scores + _mlp_fwd(T_dec, D, F))
        head = 2 * T_dec * D * V if kind == "train" else 2 * B * D * V
        return enc + dec, head

    # token-stack families
    per_layer_attn = []
    for i in range(L):
        if cfg.family == "hybrid" and cfg.sliding_window and i not in cfg.global_layers:
            skv = S_kv if kind != "decode" else min(cfg.sliding_window, S_kv)
            # impl-faithful: chunked prefill masks but computes full S_kv
            skv_impl = S_kv if kind != "decode" else skv
            per_layer_attn.append(_attn_fwd(T, skv_impl, H, KH, hd, D, cfg.qkv_bias))
        else:
            per_layer_attn.append(_attn_fwd(T, S_kv, H, KH, hd, D, cfg.qkv_bias))
    attn_total = sum(per_layer_attn)

    if cfg.family == "moe":
        ffn_total = L * _moe_fwd(T, cfg)
    else:
        ffn_total = L * _mlp_fwd(T, D, F, cfg.mlp_gated)
    ssm_total = L * _ssm_fwd(T, cfg) if cfg.family == "hybrid" else 0.0
    head = 2 * T * D * V if kind == "train" else 2 * B * D * V
    return attn_total + ffn_total + ssm_total, head


def step_cost(cfg: ModelConfig, shape: ShapeConfig, mesh_shape: dict) -> StepCost:
    """Total-job per-step cost for the cell's step function."""
    kind = shape.kind
    layers_fwd, head_fwd = fwd_flops_layerwise(cfg, shape, kind)
    N = param_count(cfg)
    Na = active_param_count(cfg)
    n_chips = 1
    for v in mesh_shape.values():
        n_chips *= v

    if kind == "train":
        remat_factor = 4.0 if cfg.remat == "full" else 3.0  # fwd+bwd(2x)+re-fwd
        flops = layers_fwd * remat_factor + head_fwd * 3.0
        tokens = shape.tokens
        model_flops = 6.0 * Na * tokens
    else:
        flops = layers_fwd + head_fwd
        tokens = shape.global_batch if kind == "decode" else shape.tokens
        model_flops = 2.0 * Na * tokens

    bytes_hbm = _bytes_model(cfg, shape, kind, mesh_shape, N)
    return StepCost(flops=flops, bytes_hbm=bytes_hbm, model_flops=model_flops, params=N)


def _bytes_model(cfg: ModelConfig, shape: ShapeConfig, kind: str, mesh_shape: dict,
                 N: float) -> float:
    """Coarse HBM-traffic model (total across job, per step).

    train : weights bf16 read x3 (fwd/bwd/remat) + AdamW fp32 m/v/p rw (24B) +
            grad write (4B) -> ~34B/param consumed per TP rank, plus
            activation stream ~ 2B * tokens * (10*D + 4*F_eff) per layer.
    decode: weights bf16 once + full KV-cache read + small activations.
    """
    D, F, L = cfg.d_model, cfg.d_ff, cfg.num_layers
    KH, hd = cfg.num_kv_heads, cfg.head_dim_
    model_par = mesh_shape.get("model", 1)
    B, S = shape.global_batch, shape.seq_len
    n_chips = 1
    for v in mesh_shape.values():
        n_chips *= v

    F_eff = cfg.moe.d_ff_expert * cfg.moe.top_k if cfg.family == "moe" else F
    if cfg.family == "ssm":
        F_eff = 2 * D

    if kind == "train":
        weight_traffic = N * (3 * 2 + 4 + 24) * (n_chips / model_par) / n_chips * n_chips
        # each TP rank reads N/model_par params; n_chips/model_par ranks groups ->
        # total = N/model_par * 2B * 3 * n_chips ... simplify per-job:
        weight_traffic = (N / model_par) * (3 * 2) * n_chips + N * 28  # opt state sharded once
        act = 2.0 * shape.tokens * (10 * D + 4 * F_eff) * L * 2  # fwd+bwd streams
        return weight_traffic + act
    if kind == "prefill":
        weight_traffic = (N / model_par) * 2 * n_chips
        act = 2.0 * shape.tokens * (10 * D + 4 * F_eff) * L
        cache_write = 2.0 * L * B * S * KH * hd * 2
        return weight_traffic + act + cache_write
    # decode
    weight_traffic = N * 2  # every param read once per token (batch amortizes reads)
    if cfg.family == "hybrid":
        cache = 2.0 * 2 * B * (
            sum(min(cfg.sliding_window, S) for i in range(L) if i not in cfg.global_layers)
            + len(cfg.global_layers) * S) * KH * hd
        ssm_state = 4.0 * L * B * cfg.ssm.expand * D * cfg.ssm.state_dim * 2
        cache += ssm_state
    elif cfg.family == "ssm":
        H = cfg.num_heads
        cache = 4.0 * L * B * (H * hd * hd) * 2  # mLSTM matrix state rw
    elif cfg.family == "audio":
        e = cfg.encdec
        cache = 2.0 * 2 * B * e.dec_layers * (S + S // e.src_ratio) * KH * hd
    else:
        cache = 2.0 * 2 * L * B * S * KH * hd  # k+v bf16 read
    act = 2.0 * B * (10 * D + 4 * F_eff) * L
    return weight_traffic + cache + act
