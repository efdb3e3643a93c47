"""Architecture registry: ``get_config(arch)`` -> ModelConfig, plus the
reduced smoke config (same family features, tiny dims).  The port runs the
CNN family and the dense transformer so far (qwen3-1.7b is the dense config
with qk-norm and GQA that the serving tests run at smoke size)."""

from __future__ import annotations

import dataclasses
import importlib

from repro_torch.configs.base import ModelConfig

ARCH_IDS = [
    "qwen3-1.7b",
    "qwen1.5-0.5b",
    "cnn-vgg11",  # the paper's own domain
]

# The reference arch a family trains under ``--family`` (always as the
# reduced smoke config).
FAMILY_DEFAULT_ARCH = {
    "dense": "qwen1.5-0.5b",
    "transformer": "qwen1.5-0.5b",  # the planned wing's family name
    "cnn": "cnn-vgg11",
}

_MODULE_FOR = {a: a.replace("-", "_").replace(".", "p") for a in ARCH_IDS}


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULE_FOR:
        raise ValueError(f"unknown arch {arch!r}; have {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULE_FOR[arch]}")
    return mod.CONFIG


def smoke_config(arch: str) -> ModelConfig:
    """Reduced config of the same family, runnable on CPU in one train step:
    4 layers of width 128 with 4 heads of 32 for a transformer; for the
    CNN, 2 stages of width 8, d_ff 64 and 10 classes."""
    cfg = get_config(arch)
    changes: dict = dict(
        n_layers=min(cfg.n_layers, 4),
        d_model=128,
        vocab=256,
        d_ff=256,
        max_seq=512,
    )
    if cfg.n_heads:
        changes.update(n_heads=4, n_kv_heads=max(1, 4 * cfg.n_kv_heads // cfg.n_heads),
                       head_dim=32)
    if cfg.family == "cnn":
        changes.update(n_layers=2, d_model=8, d_ff=64, vocab=10)
    return dataclasses.replace(cfg, name=cfg.name + "-smoke", **changes)
