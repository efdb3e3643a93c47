"""qwen3-moe-235b-a22b [moe]: 94L d_model=4096 64H (GQA kv=4) expert
d_ff=1536 vocab=151936, MoE 128 experts top-8. [hf:Qwen/Qwen3-30B-A3B; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4, head_dim=128,
    d_ff=1536, vocab=151936,
    n_experts=128, moe_top_k=8, qk_norm=True, act="silu", tie_embeddings=False,
    rope_theta=1e6, max_seq=32768,
)
