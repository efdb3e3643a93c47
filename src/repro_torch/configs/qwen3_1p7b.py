"""qwen3-1.7b [dense]: 28L d_model=2048 16H (GQA kv=8) d_ff=6144
vocab=151936; qk_norm. [hf:Qwen/Qwen3-8B; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-1.7b", family="dense",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=8, head_dim=128,
    d_ff=6144, vocab=151936,
    qk_norm=True, act="silu", tie_embeddings=True,
    rope_theta=1e6, max_seq=32768,
)
