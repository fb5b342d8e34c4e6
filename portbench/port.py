"""The program under test, as the drivers reach it: its configuration of an
arch, checked number for number against the benchmark's configuration file,
so that a change to the program's sizes cannot pass unseen.

``meta_tokens`` and ``kv_groups`` (``reference/hybrid.py``) are compared
with the program's ``ModelConfig`` attributes of the same names, read as
0 and no groups where the program has none: a file that declares meta
tokens or K/V groups differs from a program without them."""
from __future__ import annotations

import math

#: configuration-file key -> the program's ``ModelConfig`` attribute
FIELDS = {"family": "family", "num_layers": "num_layers", "d_model": "d_model",
          "num_heads": "num_heads", "num_kv_heads": "num_kv_heads", "head_dim": "head_dim_",
          "d_ff": "d_ff", "mlp_gated": "mlp_gated", "vocab_size": "vocab_size",
          "vocab_padded": "vocab_padded", "rope_theta": "rope_theta", "norm_eps": "norm_eps",
          "sliding_window": "sliding_window"}


def _port_values(pc) -> dict:
    out = {k: getattr(pc, a) for k, a in FIELDS.items()}
    out["global_layers"] = list(pc.global_layers)
    out["meta_tokens"] = getattr(pc, "meta_tokens", 0)
    out["kv_groups"] = [list(g) for g in getattr(pc, "kv_groups", ())]
    out["dtypes.param"], out["dtypes.compute"] = pc.param_dtype, pc.compute_dtype
    if pc.ssm is not None:
        s = pc.ssm
        out["ssm"] = {"state_dim": s.state_dim, "conv_dim": s.conv_dim, "expand": s.expand,
                      "dt_rank": s.dt_rank or max(1, -(-pc.d_model // 16))}
    if pc.frontend is not None:
        out["patch_positions"], out["patch_dim"] = (pc.frontend.num_positions,
                                                    pc.frontend.embed_dim)
    return out


def _file_values(cfg: dict) -> dict:
    out = {k: cfg[k] for k in FIELDS if k in cfg}
    out["global_layers"] = list(cfg.get("global_layers", []))
    out["meta_tokens"] = cfg.get("meta_tokens", 0)
    out["kv_groups"] = [list(g) for g in cfg.get("kv_groups", [])]
    out["dtypes.param"], out["dtypes.compute"] = cfg["dtypes"]["param"], cfg["dtypes"]["compute"]
    for k in ("ssm", "patch_positions", "patch_dim"):
        if k in cfg:
            out[k] = cfg[k]
    return out


def model_config(cfg: dict, smoke: bool = False, **replace):
    """The program's ``ModelConfig`` of ``cfg["arch"]`` (its smoke config with
    ``smoke``, for the tests); raises where any of its sizes differs from the
    file's."""
    from repro_torch.configs import get_config, get_smoke_config

    pc = (get_smoke_config if smoke else get_config)(cfg["arch"])
    port, want = _port_values(pc), _file_values(cfg)
    bad = {k: (port.get(k), v) for k, v in want.items()
           if not (port.get(k) == v or (isinstance(v, float) and isinstance(port.get(k), float)
                                        and math.isclose(port[k], v, rel_tol=1e-12)))}
    if bad:
        raise ValueError(f"{cfg['arch']}: the program's configuration differs from "
                         f"{cfg['name']}'s file (program, file): {bad}")
    return pc.replace(**replace) if replace else pc
