"""xlstm-125m [ssm] — 12L d_model=768 4H d_ff=0 vocab=50304.

sLSTM + mLSTM blocks (alternating). [arXiv:2405.04517; unverified]
No attention KV cache: serve_step carries recurrent state — the KV-partition
chunnel is inapplicable (see DESIGN.md §Arch-applicability). Sub-quadratic:
long_500k runs.
"""
from repro_torch.configs.base import ModelConfig, XLSTMConfig

CONFIG = ModelConfig(
    name="xlstm-125m",
    family="ssm",
    num_layers=12,
    d_model=768,
    num_heads=4,
    num_kv_heads=4,
    head_dim=192,
    d_ff=0,  # xLSTM blocks carry their own up/down projections (expand=2)
    vocab_size=50304,
    norm_eps=1e-5,
    xlstm=XLSTMConfig(slstm_every=2, chunk_size=64),
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        name="xlstm-smoke",
        num_layers=2,
        d_model=64,
        num_heads=2,
        num_kv_heads=2,
        head_dim=32,
        vocab_size=256,
        xlstm=XLSTMConfig(slstm_every=2, chunk_size=16),
    )
