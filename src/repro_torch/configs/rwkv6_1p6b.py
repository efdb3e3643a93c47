"""rwkv6-1.6b [ssm]: 24L d_model=2048 (attention-free) d_ff=7168
vocab=65536; Finch data-dependent decay. [arXiv:2404.05892; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b", family="rwkv6",
    n_layers=24, d_model=2048, d_ff=7168, vocab=65536,
    ssm_head_dim=64, tie_embeddings=False, max_seq=524288,
)
