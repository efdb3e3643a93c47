"""seamless-m4t-medium [audio]: 12L enc + 12L dec, d_model=1024 16H (MHA)
d_ff=4096 vocab=256206; multimodal enc-dec, audio frontend stubbed
(precomputed frame embeddings). [arXiv:2308.11596; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium", family="encdec",
    n_layers=12, n_enc_layers=12, d_model=1024, n_heads=16, n_kv_heads=16,
    head_dim=64, d_ff=4096, vocab=256206,
    act="relu", tie_embeddings=True, enc_seq=4096, max_seq=32768,
)
