"""phi-3-vision-4.2b [vlm] — 32L d_model=3072 32H (MHA kv=32) d_ff=8192 vocab=32064.

phi3-mini backbone + CLIP frontend. [hf:microsoft/Phi-3-vision-128k-instruct; hf]
The CLIP frontend is a STUB: input_specs() provides 576 precomputed patch
embeddings occupying the first 576 sequence positions; the rest are text tokens.
"""
from repro_torch.configs.base import FrontendConfig, ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b",
    family="vlm",
    num_layers=32,
    d_model=3072,
    num_heads=32,
    num_kv_heads=32,
    head_dim=96,
    d_ff=8192,
    vocab_size=32064,
    rope_theta=1e6,
    norm_eps=1e-5,
    frontend=FrontendConfig(kind="patch", num_positions=576, embed_dim=3072),
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        name="phi3v-smoke",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        attn_impl="xla_dense",
        frontend=FrontendConfig(kind="patch", num_positions=8, embed_dim=64),
    )
