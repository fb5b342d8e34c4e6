"""seamless-m4t-medium [audio] — 12L d_model=1024 16H (kv=16) d_ff=4096 vocab=256206.

Encoder-decoder, multimodal. [arXiv:2308.11596; hf]
The audio frontend is a STUB: input_specs() provides precomputed frame embeddings
of length seq_len // 4 (conv-subsampled frames). num_layers=12 per stack
(12 encoder + 12 decoder), matching the assignment's per-stack layer count.
"""
from repro_torch.configs.base import EncDecConfig, FrontendConfig, ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="audio",
    num_layers=12,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=256206,
    rope_theta=1e4,
    norm="layernorm",
    norm_eps=1e-5,
    encdec=EncDecConfig(enc_layers=12, dec_layers=12, src_ratio=4),
    frontend=FrontendConfig(kind="frames", num_positions=0, embed_dim=1024),
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        name="seamless-smoke",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        attn_impl="xla_dense",
        encdec=EncDecConfig(enc_layers=2, dec_layers=2, src_ratio=4),
        frontend=FrontendConfig(kind="frames", num_positions=0, embed_dim=64),
    )
