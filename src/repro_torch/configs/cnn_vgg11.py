"""The paper's own domain: VGG-style CNN on 32x32x3 images, built from
core.conv_layer / core.fc_layer (Algs 1-5)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="cnn-vgg11", family="cnn",
    n_layers=4, d_model=64, d_ff=4096, vocab=1000,
)
