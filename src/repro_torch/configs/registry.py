"""Architecture registry: ``get_config(arch)`` -> ModelConfig, plus the
reduced smoke config (same family features, tiny dims) and the assigned
shape cells of each arch.  The port holds every arch of the JAX package's
registry, in its order: the dense transformers (gemma3-4b with its 5:1
local:global attention, qwen3-1.7b and qwen3-32b with qk-norm and GQA,
qwen1.5-0.5b, chameleon-34b), the MoE (grok-1-314b, qwen3-moe-235b-a22b),
RWKV-6, the encoder-decoder, the Mamba-2 hybrid Zamba2 and the CNN."""

from __future__ import annotations

import dataclasses
import importlib

from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig

ARCH_IDS = [
    "gemma3-4b",
    "qwen3-1.7b",
    "qwen3-32b",
    "qwen1.5-0.5b",
    "grok-1-314b",
    "qwen3-moe-235b-a22b",
    "chameleon-34b",
    "rwkv6-1.6b",
    "seamless-m4t-medium",
    "zamba2-1.2b",
    "cnn-vgg11",  # the paper's own domain
]

# The reference arch a family trains under ``--family`` (always as the
# reduced smoke config).
FAMILY_DEFAULT_ARCH = {
    "dense": "qwen1.5-0.5b",
    "transformer": "qwen1.5-0.5b",  # the planned wing's family name
    "moe": "qwen3-moe-235b-a22b",
    "rwkv6": "rwkv6-1.6b",
    "zamba2": "zamba2-1.2b",
    "encdec": "seamless-m4t-medium",
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
    4 layers (Zamba2: 5) of width 128 with 4 heads of 32; 4 experts with
    top-k at most 2; 2 encoder layers over 64 frames; SSM heads of 32
    (Zamba2 also state 16, shared attention every 2 layers); for the CNN,
    2 stages of width 8, d_ff 64 and 10 classes; a local:global config
    keeps its cadence with a window of 64."""
    cfg = get_config(arch)
    changes: dict = dict(
        n_layers=min(cfg.n_layers, 4 if cfg.family != "zamba2" else 5),
        d_model=128,
        vocab=256,
        d_ff=256,
        max_seq=512,
    )
    if cfg.n_heads:
        changes.update(n_heads=4, n_kv_heads=max(1, 4 * cfg.n_kv_heads // cfg.n_heads),
                       head_dim=32)
    if cfg.n_experts:
        changes.update(n_experts=4, moe_top_k=min(cfg.moe_top_k, 2))
    if cfg.n_enc_layers:
        changes.update(n_enc_layers=2, enc_seq=64)
    if cfg.family == "zamba2":
        changes.update(ssm_state=16, ssm_head_dim=32, shared_attn_every=2)
    if cfg.family == "rwkv6":
        changes.update(ssm_head_dim=32)
    if cfg.family == "cnn":
        changes.update(n_layers=2, d_model=8, d_ff=64, vocab=10)
    if cfg.local_window:
        changes.update(local_window=64, global_every=cfg.global_every)
    return dataclasses.replace(cfg, name=cfg.name + "-smoke", **changes)


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]


# long_500k needs sub-quadratic attention over the context: runnable for
# the recurrent, hybrid and local-attention archs, skipped for the pure
# full-attention ones.
LONG_CONTEXT_OK = {"rwkv6-1.6b", "zamba2-1.2b", "gemma3-4b"}
# Every arch but the CNN has a decoder, so the decode shapes apply to it;
# the CNN trains on images.
CNN_ARCHS = {"cnn-vgg11"}


def cells(arch: str) -> list[str]:
    """The assigned shape cells of an arch, with the skips above."""
    if arch in CNN_ARCHS:
        return ["train_4k"]  # batch-256 image training; seq axes n/a
    shapes = ["train_4k", "prefill_32k", "decode_32k"]
    if arch in LONG_CONTEXT_OK:
        shapes.append("long_500k")
    return shapes
