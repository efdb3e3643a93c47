"""grok-1-314b [moe]: 64L d_model=6144 48H (GQA kv=8) d_ff=32768
vocab=131072, MoE 8 experts top-2. [hf:xai-org/grok-1; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b", family="moe",
    n_layers=64, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=32768, vocab=131072,
    n_experts=8, moe_top_k=2, act="gelu", tie_embeddings=False,
    rope_theta=1e4, max_seq=32768,
)
