"""Zamba2: a Mamba-2 backbone with one *shared* attention+MLP block applied
after every ``cfg.shared_attn_every`` Mamba layers, its parameters reused at
every application — the JAX package's ``models/zamba2.py`` on one device.

The cache is flat like the parameters: the Mamba states under
``mamba/conv`` and ``mamba/ssd`` (one row a layer) and a KV cache ``k``/``v``
with one row per application of the shared block, each with the slot on
axis 1; ``forward`` writes it in place.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as ll
from repro_torch.models import mamba2
from repro_torch.models.module import ParamDef, prefixed, subtree, unstack
from repro_torch.models.transformer import _check_remat, _layer


def _segments(cfg: ModelConfig) -> list[int]:
    """Mamba-layer run lengths between shared-block applications."""
    every = cfg.shared_attn_every or cfg.n_layers
    segs, left = [], cfg.n_layers
    while left > 0:
        segs.append(min(every, left))
        left -= every
    return segs


def n_shared_applications(cfg: ModelConfig) -> int:
    return sum(1 for s in _segments(cfg) if s == (cfg.shared_attn_every or cfg.n_layers))


def param_defs(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    mlp = {k: ParamDef(v.shape[1:], v.spec[1:], fan_in_axis=0)
           for k, v in ll.mlp_defs(cfg, 1).items()}
    return {
        **ll.embed_defs(cfg),
        **prefixed("mamba", mamba2.block_defs(cfg, cfg.n_layers)),
        # The one shared transformer block (unstacked).
        "shared/ln1": ParamDef((d,), init="zeros"),
        "shared/ln2": ParamDef((d,), init="zeros"),
        **prefixed("shared/attn", ll.attn_defs(cfg, 0, layers_prefix=False)),
        **prefixed("shared/mlp", mlp),
    }


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=torch.bfloat16, *,
               device=None) -> dict:
    state = mamba2.init_block_state(cfg, cfg.n_layers, batch, dtype, device=device)
    shape = (n_shared_applications(cfg), batch, max_seq, cfg.n_kv_heads,
             cfg.resolved_head_dim)
    dev = state["ssd"].device
    return {"mamba/conv": state["conv"], "mamba/ssd": state["ssd"],
            "k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def _shared_block(p, x, cfg, pos0, kv):
    h = ll.rms_norm(x, p["ln1"], cfg.norm_eps)
    h, _ = ll.apply_attention(p["attn"], h, cfg, pos0=pos0, cache=kv)
    x = x + h
    h = ll.rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + ll.apply_mlp(p["mlp"], h, cfg.act)


def forward(cfg: ModelConfig, params: dict, tokens: torch.Tensor, *, pos0=0,
            cache: dict | None = None, compute_dtype=torch.float32, remat: str = "none"):
    """Returns (hidden [B, S, d], cache).  ``remat="block"`` recomputes each
    Mamba layer in the backward pass (the JAX package checkpoints its
    Mamba scan body alone)."""
    _check_remat(remat)
    B, _ = tokens.shape
    x = ll.embed_tokens(params, tokens, cfg, compute_dtype)
    if cache is None:
        zero = mamba2.init_block_state(cfg, cfg.n_layers, B, compute_dtype, device=x.device)
        conv, ssd = zero["conv"], zero["ssd"]
    else:
        conv, ssd = cache["mamba/conv"], cache["mamba/ssd"]

    def mamba_layer(x, lp, conv_s, ssd_s):
        h = ll.rms_norm(x, lp["ln"], cfg.norm_eps)
        h, st = mamba2.apply_block(lp, h, cfg, {"conv": conv_s, "ssd": ssd_s})
        return x + h, st["conv"], st["ssd"]

    layers = unstack(params, "mamba", cfg.n_layers)
    shared = subtree(params, "shared")
    every = cfg.shared_attn_every or cfg.n_layers
    off = app = 0
    for seg in _segments(cfg):
        for i in range(off, off + seg):
            x, c, s = _layer(mamba_layer, remat)(x, layers[i], conv[i], ssd[i])
            if cache is not None:
                conv[i] = c.to(conv.dtype)
                ssd[i] = s
        off += seg
        if seg == every:
            kv = (cache["k"][app], cache["v"][app]) if cache is not None else None
            x = _shared_block(shared, x, cfg, pos0, kv)
            app += 1
    return x, cache


def logits(cfg: ModelConfig, params: dict, hidden: torch.Tensor) -> torch.Tensor:
    return ll.logits_from_hidden(params, hidden, cfg)


def layer_meta(cfg: ModelConfig) -> dict:
    return {}
