"""Config system: the model, training and run config dataclasses and the
4 shape presets (the fields the JAX package's carry, so a config reads the
same in both packages)."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | rwkv6 | zamba2 | encdec | cnn
    n_layers: int
    d_model: int
    vocab: int
    d_ff: int = 0
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int | None = None  # None -> d_model // n_heads
    qk_norm: bool = False
    qkv_bias: bool = False
    act: str = "silu"
    norm_eps: float = 1e-6
    tie_embeddings: bool = True
    scale_embed: bool = False
    rope_theta: float = 1e4
    # gemma3-style local:global attention
    local_window: int | None = None
    global_every: int = 0  # every Nth layer is global; 0 = all global
    rope_theta_global: float | None = None
    # MoE
    n_experts: int = 0
    moe_top_k: int = 0
    capacity_factor: float = 1.25
    # SSM / hybrid
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    conv_width: int = 4
    shared_attn_every: int = 0  # zamba2: shared attn block cadence
    # encoder-decoder
    n_enc_layers: int = 0
    enc_seq: int = 4096  # stub audio-frontend frame count
    max_seq: int = 524288

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def attention_free(self) -> bool:
        return self.family == "rwkv6"


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""

    name: str
    kind: str  # train | prefill | decode
    seq_len: int
    global_batch: int


# The assigned shape set (applies to every architecture).
SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524288, 1),
}


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """The training knobs the port's trainer reads: the JAX package's
    TrainConfig fields of the same names and defaults, except compute in
    float32 (the port's kernels are f32).  The sharding knob (``zero1``)
    comes with the slice that ports the sharded trainer."""

    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10000
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    microbatch: int = 0  # 0 = no gradient accumulation
    remat: str = "block"  # none | dots | block
    seed: int = 0
    loss_chunks: int = 8  # chunked cross-entropy over tokens
    grad_compression: str = "none"  # none | int8_ef
    # Run the family's planned kernels (forward AND planned backward) in the
    # train step instead of the plain PyTorch path: for the cnn, the fused
    # conv + dgrad/wgrad + dX/dW matmul kernels; for the transformer, every
    # block GEMM + flash attention + dX/dW.
    planned_kernels: bool = False


@dataclasses.dataclass(frozen=True)
class RunConfig:
    model: ModelConfig
    train: TrainConfig
    shape: ShapeConfig
