"""Configuration files made from the program's configs, for the CPU tests:
the same keys as ``configs/*.json``, at the sizes of
``repro_torch.configs.get_smoke_config`` (or of ``get_config`` with
``smoke=False``, for counts and shapes that build nothing)."""
from __future__ import annotations


def program_cfg(arch: str, name: str = "smoke", smoke: bool = True) -> dict:
    from repro_torch.configs import get_config, get_smoke_config

    pc = (get_smoke_config if smoke else get_config)(arch)
    cfg = {"arch": arch, "name": name, "family": pc.family, "num_layers": pc.num_layers,
           "d_model": pc.d_model, "num_heads": pc.num_heads, "num_kv_heads": pc.num_kv_heads,
           "head_dim": pc.head_dim_, "d_ff": pc.d_ff, "mlp_gated": pc.mlp_gated,
           "vocab_size": pc.vocab_size, "vocab_padded": pc.vocab_padded,
           "rope_theta": pc.rope_theta, "norm_eps": pc.norm_eps,
           "sliding_window": pc.sliding_window, "global_layers": list(pc.global_layers),
           "dtypes": {"param": "float32", "compute": "bfloat16", "kv_cache": "bfloat16",
                      "ssm_dt": "float32", "ssm_state": "float32", "ssm_out": "float32",
                      "moments": "bfloat16"}}
    if getattr(pc, "meta_tokens", 0):  # where the program has them
        cfg["meta_tokens"] = pc.meta_tokens
    if getattr(pc, "kv_groups", ()):
        cfg["kv_groups"] = [list(g) for g in pc.kv_groups]
    if pc.ssm is not None:
        s = pc.ssm
        cfg["ssm"] = {"state_dim": s.state_dim, "conv_dim": s.conv_dim, "expand": s.expand,
                      "dt_rank": s.dt_rank or max(1, -(-pc.d_model // 16))}
    if pc.frontend is not None:
        cfg["patch_positions"], cfg["patch_dim"] = (pc.frontend.num_positions,
                                                    pc.frontend.embed_dim)
    return cfg
