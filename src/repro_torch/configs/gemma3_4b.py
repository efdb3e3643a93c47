"""gemma3-4b [dense]: 34L d_model=2560 8H (GQA kv=4) d_ff=10240 vocab=262144;
5:1 local:global attention, 128k+ context. [hf:google/gemma-3-1b-pt; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-4b", family="dense",
    n_layers=34, d_model=2560, n_heads=8, n_kv_heads=4, head_dim=256,
    d_ff=10240, vocab=262144,
    qk_norm=True, act="gelu", tie_embeddings=True, scale_embed=True,
    local_window=1024, global_every=6,  # 5 local : 1 global
    rope_theta=1e4, rope_theta_global=1e6,
    max_seq=524288,
)
