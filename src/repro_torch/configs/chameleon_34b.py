"""chameleon-34b [vlm]: 48L d_model=8192 64H (GQA kv=8) d_ff=22016
vocab=65536 (early-fusion VQ image + text tokens; frontend is a stub per
the assignment — inputs are token ids in the shared vocab).
[arXiv:2405.09818; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b", family="dense",
    n_layers=48, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=22016, vocab=65536,
    qk_norm=True, act="silu", tie_embeddings=False,
    rope_theta=1e4, max_seq=32768,
)
