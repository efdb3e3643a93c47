"""Zamba2: a Mamba-2 backbone with one *shared* attention+MLP block applied
after every ``cfg.shared_attn_every`` Mamba layers, its parameters reused at
every application — the JAX package's ``models/zamba2.py`` on one device.

The cache is flat like the parameters: the Mamba states under
``mamba/conv`` and ``mamba/ssd`` (one row a layer) and a KV cache ``k``/``v``
with one row per application of the shared block, each with the slot on
axis 1; ``forward`` writes it in place.

On a mesh (``parallel=``, a ParallelCtx whose model axis is above 1) the
Mamba-2 blocks run on each rank's heads (``models/mamba2.py``) and the
shared block's attention and MLP tensor-parallel as the dense family's do
(``models/layers.py``); a cache is this rank's piece: its heads of the
Mamba states and the KV heads ``layers.cache_heads`` gives.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as ll
from repro_torch.models import mamba2
from repro_torch.models.module import ParamDef, prefixed, subtree, unstack
from repro_torch.models.transformer import _check_remat, _layer
from repro_torch.runtime import parallel as par

# The leaves a model rank uses whole where the specs split them: the Mamba-2
# blocks' (``mamba2.WHOLE_OVER_MODEL``).
WHOLE_OVER_MODEL = tuple(f"mamba/{k}" for k in mamba2.WHOLE_OVER_MODEL)


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
               device=None, parallel=None) -> dict:
    """Zero states, on ``device`` (default: the card); with ``parallel``
    (a model axis above 1) this model rank's piece of them."""
    state = mamba2.init_block_state(cfg, cfg.n_layers, batch, dtype, device=device,
                                    parallel=parallel)
    kv_heads = (ll.cache_heads(cfg, parallel)[1] if par.tp_size(parallel) > 1
                else cfg.n_kv_heads)
    shape = (n_shared_applications(cfg), batch, max_seq, kv_heads, cfg.resolved_head_dim)
    dev = state["ssd"].device
    return {"mamba/conv": state["conv"], "mamba/ssd": state["ssd"],
            "k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def _shared_block(p, x, cfg, pos0, kv, parallel=None, kv_split=None):
    h = ll.rms_norm(x, p["ln1"], cfg.norm_eps)
    h, _ = ll.apply_attention(p["attn"], h, cfg, pos0=pos0, cache=kv, parallel=parallel,
                              kv_split=kv_split)
    x = x + h
    h = ll.rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + ll.apply_mlp(p["mlp"], h, cfg.act, parallel, d_ff=cfg.d_ff)


def forward(cfg: ModelConfig, params: dict, tokens: torch.Tensor, *, pos0=0,
            cache: dict | None = None, compute_dtype=torch.float32, remat: str = "none",
            parallel=None, kv_split=None):
    """Returns (hidden [B, S, d], cache).  ``remat="block"`` recomputes each
    Mamba layer in the backward pass (the JAX package checkpoints its
    Mamba scan body alone).  With ``parallel`` the tokens are this rank's
    data shard, the blocks run over the model axis and a cache is this
    rank's piece (:func:`init_cache`; with ``kv_split`` the shared block's
    ``k``/``v`` hold its piece of the sequence)."""
    _check_remat(remat)
    B, _ = tokens.shape
    x = ll.embed_tokens(params, tokens, cfg, compute_dtype, parallel)
    if cache is None:
        zero = mamba2.init_block_state(cfg, cfg.n_layers, B, compute_dtype, device=x.device,
                                       parallel=parallel)
        conv, ssd = zero["conv"], zero["ssd"]
    else:
        conv, ssd = cache["mamba/conv"], cache["mamba/ssd"]

    def mamba_layer(x, lp, conv_s, ssd_s):
        h = ll.rms_norm(x, lp["ln"], cfg.norm_eps)
        h, st = mamba2.apply_block(lp, h, cfg, {"conv": conv_s, "ssd": ssd_s}, parallel)
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
            x = _shared_block(shared, x, cfg, pos0, kv, parallel, kv_split)
            app += 1
    return x, cache


def logits(cfg: ModelConfig, params: dict, hidden: torch.Tensor,
           parallel=None) -> torch.Tensor:
    """Hidden -> logits [B, S, V] (this rank's vocab columns under a vocab
    split over ``parallel``'s model axis)."""
    return ll.logits_from_hidden(params, hidden, cfg, parallel)


def layer_meta(cfg: ModelConfig) -> dict:
    return {}
