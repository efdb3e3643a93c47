"""zamba2-1.2b [hybrid]: 38L d_model=2048, Mamba2 (ssm_state=64) + shared
attention blocks (32H MHA, d_ff=8192), vocab=32000. [arXiv:2411.15242; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b", family="zamba2",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
    d_ff=8192, vocab=32000,
    ssm_state=64, ssm_head_dim=64, ssm_expand=2, conv_width=4,
    shared_attn_every=6, tie_embeddings=True, max_seq=524288,
)
