"""dbrx-132b [moe] — 40L d_model=6144 48H (GQA kv=8) d_ff=10752 vocab=100352.

MoE: 16 experts, top-4, fine-grained. [hf:databricks/dbrx-base; unverified]
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="dbrx-132b",
    family="moe",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=10752,
    vocab_size=100352,
    rope_theta=5e5,
    norm_eps=1e-5,
    moe=MoEConfig(num_experts=16, top_k=4, d_ff_expert=10752),
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        name="dbrx-smoke",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=96,
        vocab_size=256,
        attn_impl="xla_dense",
        moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=96),
    )
