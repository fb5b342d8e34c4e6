"""granite-34b [dense] — 88L d_model=6144 48H (MQA kv=1) d_ff=24576 vocab=49152.

Llama-architecture code model; multi-query attention. [arXiv:2405.04324; hf]
kv=1 < model-axis 16 forces the sequence-sharded KV-cache chunnel for decode.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-34b",
    family="dense",
    num_layers=88,
    d_model=6144,
    num_heads=48,
    num_kv_heads=1,
    head_dim=128,
    d_ff=24576,
    vocab_size=49152,
    rope_theta=1e4,
    norm_eps=1e-5,
    remat_group=2,
    # gpt-bigcode heritage: classic 2-matrix gelu MLP (yields the declared 34B;
    # a gated SwiGLU at d_ff=24576 would be ~47B)
    act="gelu",
    mlp_gated=False,
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        name="granite-34b-smoke",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=1,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        attn_impl="xla_dense",
    )
