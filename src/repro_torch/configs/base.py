"""Config schema for Berthax model architectures and run shapes.

Every assigned architecture gets a module ``src/repro/configs/<id>.py`` exposing
``CONFIG`` (the exact published dims) and ``smoke_config()`` (a reduced config of
the same family for CPU smoke tests).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Sequence, Tuple


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    router_jitter: float = 0.0
    # Select between dispatch implementations (a Bertha routing chunnel).
    dispatch: str = "alltoall"  # "alltoall" | "allgather" | "dense"


@dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 16
    conv_dim: int = 4
    expand: int = 2
    dt_rank: Optional[int] = None  # default ceil(d_model/16)


@dataclass(frozen=True)
class XLSTMConfig:
    # Ratio of sLSTM:mLSTM blocks; blocks alternate in segments.
    slstm_every: int = 2  # every Nth block is an sLSTM block (rest mLSTM)
    chunk_size: int = 64  # chunkwise-parallel mLSTM chunk length


@dataclass(frozen=True)
class EncDecConfig:
    enc_layers: int
    dec_layers: int
    # Audio/encoder source length as a fraction of the shape's seq_len:
    # seamless stub provides precomputed frames at seq_len // src_ratio.
    src_ratio: int = 4


@dataclass(frozen=True)
class FrontendConfig:
    """Modality frontend STUB: input_specs() provides precomputed embeddings."""

    kind: str  # "patch" (vision) | "frames" (audio)
    num_positions: int  # e.g. 576 CLIP patches
    embed_dim: int  # frontend output dim (== d_model after projection)


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | audio | vlm | hybrid
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None  # defaults to d_model // num_heads
    qkv_bias: bool = False
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    act: str = "silu"
    mlp_gated: bool = True  # SwiGLU (3 mats) vs classic 2-mat MLP (granite)
    tie_embeddings: bool = False
    max_position_embeddings: int = 131072

    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    xlstm: Optional[XLSTMConfig] = None
    encdec: Optional[EncDecConfig] = None
    frontend: Optional[FrontendConfig] = None

    # Attention structure
    sliding_window: Optional[int] = None  # None = full attention
    global_layers: Tuple[int, ...] = ()  # layers with full attn (hymba)
    # Attention implementation Select (a Bertha chunnel choice):
    #   xla_dense    materialized scores (small seqs)
    #   xla_chunked  online-softmax scan over KV blocks (default at scale)
    #   pallas       TPU flash-attention kernel (validated in interpret mode)
    attn_impl: str = "xla_chunked"
    attn_chunk: int = 1024

    # Training knobs
    remat: str = "full"  # none | full | dots
    remat_group: int = 1  # checkpoint every N layers (saved-stack / N)
    scan_layers: bool = True
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    # Sequence-chunked LM loss (None = materialize all logits; used by the
    # roofline validation probes so the lm-head matmul isn't inside a scan)
    loss_chunk: Optional[int] = 512

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    @property
    def vocab_padded(self) -> int:
        """Embedding/lm-head allocation size: vocab padded to a multiple of 256
        so the vocab dim shards over any mesh axis (Megatron-style). Logits at
        padded columns are masked to -inf in the loss/decode paths."""
        return -(-self.vocab_size // 256) * 256

    @property
    def head_dim_(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.num_heads

    @property
    def q_group(self) -> int:
        return self.num_heads // self.num_kv_heads

    def validate(self) -> None:
        assert self.num_heads % self.num_kv_heads == 0, (
            f"{self.name}: heads {self.num_heads} not divisible by kv {self.num_kv_heads}"
        )
        if self.family == "moe":
            assert self.moe is not None
        if self.family == "hybrid":
            assert self.ssm is not None
        if self.family == "audio":
            assert self.encdec is not None and self.frontend is not None
        if self.family == "vlm":
            assert self.frontend is not None


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


# The four assigned LM shapes. decode_* / long_* lower serve_step (one new token
# against a KV cache of seq_len), NOT train_step.
SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

# long_500k needs sub-quadratic attention: run only for SSM/hybrid archs,
# skip (with reason recorded) for pure full-attention archs. See DESIGN.md §5.
SUBQUADRATIC_FAMILIES = ("ssm", "hybrid")


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Whether (arch, shape) is a runnable cell; reason if skipped."""
    if shape.name == "long_500k" and cfg.family not in SUBQUADRATIC_FAMILIES:
        return False, (
            "long_500k skipped: full-attention arch (O(S^2)/full-cache at 524288); "
            "run only for SSM/hybrid per assignment"
        )
    return True, ""


@dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 1000
    microbatches: int = 1  # gradient-accumulation microbatches per step
    # AdamW moment dtype: bf16 moments (fp32 master params retained) are the
    # standard memory/quality trade at 100B+ scale.
    opt_dtype: str = "bfloat16"


@dataclass(frozen=True)
class ShardingConfig:
    """How the model maps onto the production mesh (a Bertha routing chunnel)."""

    fsdp: bool = True  # shard params/opt-state over the data axis (ZeRO-3)
    # Gradient transport Select across the pod (DCN) tier:
    #   xla | ring | hierarchical | compressed_int8 | localsgd
    pod_transport: str = "xla"
    # KV-cache partitioning for decode: "auto" resolves per-arch:
    #   heads if num_kv_heads % model_axis == 0 else sequence (flash-decode).
    kv_partition: str = "auto"
    remat: str = "full"
