"""hymba-1.5b [hybrid] — 32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001.

Parallel attention + mamba heads per layer; ssm_state=16. [arXiv:2411.13676; hf]
Sliding-window attention (1024) for all layers except 3 global layers
(first/middle/last), so long_500k is sub-quadratic and runs.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    num_layers=32,
    d_model=1600,
    num_heads=25,
    num_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab_size=32001,
    rope_theta=1e4,
    norm_eps=1e-5,
    sliding_window=1024,
    global_layers=(0, 15, 31),
    # 25 heads don't divide the model axis (replicated attention heads):
    # smaller KV chunks keep the per-chunk score transients ~1GB
    attn_chunk=256,
    ssm=SSMConfig(state_dim=16, conv_dim=4, expand=2),
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        name="hymba-smoke",
        num_layers=4,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        attn_impl="xla_dense",
        sliding_window=8,
        global_layers=(0, 3),
        ssm=SSMConfig(state_dim=4, conv_dim=4, expand=2),
    )
