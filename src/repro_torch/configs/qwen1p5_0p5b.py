"""qwen1.5-0.5b [dense]: 24L d_model=1024 16H (kv=16, MHA) d_ff=2816
vocab=151936; QKV bias. [hf:Qwen/Qwen1.5-0.5B; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-0.5b", family="dense",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16, head_dim=64,
    d_ff=2816, vocab=151936,
    qkv_bias=True, act="silu", tie_embeddings=True,
    rope_theta=1e6, max_seq=32768,
)
