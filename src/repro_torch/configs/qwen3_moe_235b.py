"""qwen3-moe-235b-a22b [moe] — 94L d_model=4096 64H (GQA kv=4) vocab=151936.

MoE: 128 experts, top-8, per-expert d_ff=1536. [hf:Qwen/Qwen3-30B-A3B; hf]
Most representative arch for the paper's technique: the MoE dispatch layer is a
Select between all-to-all EP and allgather dispatch chunnels.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    num_layers=94,
    d_model=4096,
    num_heads=64,
    num_kv_heads=4,
    head_dim=128,
    d_ff=1536,
    vocab_size=151936,
    rope_theta=1e6,
    norm_eps=1e-6,
    moe=MoEConfig(num_experts=128, top_k=8, d_ff_expert=1536),
    remat_group=1,
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        name="qwen3-moe-smoke",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=96,
        vocab_size=256,
        attn_impl="xla_dense",
        moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=96),
    )
