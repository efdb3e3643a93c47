"""Encoder-decoder backbone (seamless-m4t-medium): the JAX package's
``models/encdec.py`` on one device.

The audio frontend is a stub: ``frames`` are precomputed frame embeddings
[B, T_enc, d_model], which a linear adapter maps into the encoder.  The
encoder runs bidirectional self-attention; the decoder causal
self-attention, cross-attention over the encoder's output (no RoPE, not
causal) and the MLP.  With ``frames`` and a cache (prefill) the cross K/V
are computed once and written into the cache; a decode step (a cache,
no frames) reads them and never runs the encoder again.  The cache —
self-attention ``k``/``v`` [L, B, Smax, Hkv, Dh] and cross ``xk``/``xv``
[L, B, T_enc, Hkv, Dh] — is written in place.

On a mesh (``parallel=``, a ParallelCtx whose model axis is above 1) the
self-attention, the cross-attention and both MLPs run tensor-parallel over
the model axis, split by head and by d_ff as the dense family's blocks
(``layers.local_attn_params``, ``layers.apply_mlp``): each rank's cross
K/V are its KV heads of the encoder's output, which is replicated and
enters the split region through ``parallel.tp_enter``.  The embedding and
the logits head take the vocab split (seamless-m4t-medium's 256206 rows
are stored split over d_model, 256206 not dividing by 16; at tp = 2 the
vocab splits: the rows are gathered whole over d_model, then split).  A
cache is this rank's piece: its rows and the KV heads
``layers.cache_heads`` gives, for ``k``/``v`` and ``xk``/``xv`` alike; with
``kv_split`` (a SeqSplit: too few rows for the data axes) also its run of
the self-attention positions and of the encoder's frames, over which the
decoder's self- and cross-attention merge their pieces
(``models/attention.py``).
"""

from __future__ import annotations

import functools

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as ll
from repro_torch.models.attention import attention
from repro_torch.models.module import ParamDef, prefixed, unstack
from repro_torch.models.transformer import _check_remat, _layer
from repro_torch.runtime import parallel as par


def param_defs(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    Le, Ld = cfg.n_enc_layers, cfg.n_layers
    Hq, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    hs = ll.head_axis_spec(Hq, Dh)
    khs = ll.head_axis_spec(Hkv, Dh)
    cross = {
        "wq": ParamDef((Ld, d, Hq, Dh), (None, None) + hs, fan_in_axis=1),
        "wk": ParamDef((Ld, d, Hkv, Dh), (None, None) + khs, fan_in_axis=1),
        "wv": ParamDef((Ld, d, Hkv, Dh), (None, None) + khs, fan_in_axis=1),
        "wo": ParamDef((Ld, Hq, Dh, d), (None,) + hs + (None,), fan_in_axis=1),
    }
    return {
        **ll.embed_defs(cfg),
        "adapter": ParamDef((d, d)),
        "enc/ln1": ParamDef((Le, d), init="zeros"),
        "enc/ln2": ParamDef((Le, d), init="zeros"),
        **prefixed("enc/attn", ll.attn_defs(cfg, Le)),
        **prefixed("enc/mlp", ll.mlp_defs(cfg, Le)),
        "enc_norm": ParamDef((d,), init="zeros"),
        "dec/ln1": ParamDef((Ld, d), init="zeros"),
        "dec/ln_x": ParamDef((Ld, d), init="zeros"),
        "dec/ln2": ParamDef((Ld, d), init="zeros"),
        **prefixed("dec/attn", ll.attn_defs(cfg, Ld)),
        **prefixed("dec/cross", cross),
        **prefixed("dec/mlp", ll.mlp_defs(cfg, Ld)),
    }


def encode(cfg: ModelConfig, params: dict, frames: torch.Tensor, remat: str = "none",
           parallel=None):
    """frames [B, T_enc, d_model] (stub embeddings) -> the encoder's output."""
    x = frames @ params["adapter"].to(frames.dtype)

    def body(x, lp):
        h = ll.rms_norm(x, lp["ln1"], cfg.norm_eps)
        h, _ = ll.apply_attention(lp["attn"], h, cfg, pos0=0, causal=False, parallel=parallel)
        x = x + h
        h = ll.rms_norm(x, lp["ln2"], cfg.norm_eps)
        return x + ll.apply_mlp(lp["mlp"], h, cfg.act, parallel, d_ff=cfg.d_ff)

    for lp in unstack(params, "enc", cfg.n_enc_layers):
        x = _layer(body, remat)(x, lp)
    return ll.rms_norm(x, params["enc_norm"], cfg.norm_eps)


def cross_split(cfg: ModelConfig, parallel) -> bool:
    """Whether the cross-attention splits its heads over the model axis
    (else every rank runs it whole)."""
    return ll.attention_split(cfg, 1, parallel, cached=True) == "heads"


def _cross_kv(lp_cross: dict, memory: torch.Tensor):
    """The cross-attention K/V of the encoder's output: [B, T, Hkv, Dh] each."""
    cd = memory.dtype
    k = torch.einsum("btd,dhk->bthk", memory, lp_cross["wk"].to(cd))
    v = torch.einsum("btd,dhk->bthk", memory, lp_cross["wv"].to(cd))
    return k, v


def _dec_block(x, lp, xk, xv, *, cfg, pos0, self_cache, parallel=None, kv_split=None):
    cd = x.dtype
    B, S, _ = x.shape
    h = ll.rms_norm(x, lp["ln1"], cfg.norm_eps)
    h, _ = ll.apply_attention(lp["attn"], h, cfg, pos0=pos0, cache=self_cache,
                              parallel=parallel, kv_split=kv_split)
    x = x + h
    # Cross-attention over the encoder's output (no RoPE, not causal).
    h = ll.rms_norm(x, lp["ln_x"], cfg.norm_eps)
    cross, split = lp["cross"], cross_split(cfg, parallel)
    if split:
        cross = {k: cross[k] for k in ("wq", "wo")}
        cross, h = ll.local_attn_params(cross, cfg, parallel), par.tp_enter(h, parallel)
    q = torch.einsum("bsd,dhk->bshk", h, cross["wq"].to(cd))
    T = xk.shape[1]
    k_pos = torch.arange(T, dtype=torch.int32, device=x.device)
    if kv_split is not None:
        k_pos = k_pos + kv_split.start(T)
    out = attention(q, xk, xv, q_pos=ll.positions(pos0, B, S, x.device), k_pos=k_pos,
                    causal=False, scale=cfg.resolved_head_dim ** -0.5, kv_split=kv_split)
    out = torch.einsum("bshk,hkd->bsd", out, cross["wo"].to(cd))
    x = x + (par.tp_exit(out, parallel) if split else out)
    h = ll.rms_norm(x, lp["ln2"], cfg.norm_eps)
    return x + ll.apply_mlp(lp["mlp"], h, cfg.act, parallel, d_ff=cfg.d_ff)


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=torch.bfloat16, *,
               device=None, parallel=None) -> dict:
    """Zero caches on ``device`` (default: the card); with ``parallel`` (a
    model axis above 1) each holds this rank's KV heads."""
    Ld, Dh = cfg.n_layers, cfg.resolved_head_dim
    Hkv = ll.cache_heads(cfg, parallel)[1] if par.tp_size(parallel) > 1 else cfg.n_kv_heads
    device = torch.device("cuda" if device is None else device)
    self_shape = (Ld, batch, max_seq, Hkv, Dh)
    cross_shape = (Ld, batch, cfg.enc_seq, Hkv, Dh)
    return {"k": torch.zeros(self_shape, dtype=dtype, device=device),
            "v": torch.zeros(self_shape, dtype=dtype, device=device),
            "xk": torch.zeros(cross_shape, dtype=dtype, device=device),
            "xv": torch.zeros(cross_shape, dtype=dtype, device=device)}


def forward(cfg: ModelConfig, params: dict, tokens: torch.Tensor, *, frames=None, pos0=0,
            cache: dict | None = None, compute_dtype=torch.float32, remat: str = "none",
            parallel=None, kv_split=None):
    """Returns (hidden [B, S, d], cache).  Train: frames and tokens, no
    cache.  Prefill: frames and a cache.  Decode: a cache alone (its cross
    K/V already written); neither frames nor a cache raises, as the JAX
    package's forward asserts.  With ``parallel`` the tokens and frames
    are this rank's data shard, the blocks run over the model axis and a
    cache is this rank's piece (:func:`init_cache`); with ``kv_split`` its
    piece of the sequence and of the frames (the prefill keeps its run of
    the cross K/V)."""
    _check_remat(remat)
    x = ll.embed_tokens(params, tokens, cfg, compute_dtype, parallel)
    layers = unstack(params, "dec", cfg.n_layers)
    if frames is not None:
        memory = encode(cfg, params, frames.to(compute_dtype), remat, parallel)
        if cross_split(cfg, parallel):  # each rank its KV heads of the memory
            memory = par.tp_enter(memory, parallel)
            crosses = [ll.local_attn_params({k: lp["cross"][k] for k in ("wk", "wv")}, cfg,
                                            parallel) for lp in layers]
        else:
            crosses = [lp["cross"] for lp in layers]
        kvs = [_cross_kv(c, memory) for c in crosses]
        xk, xv = torch.stack([k for k, _ in kvs]), torch.stack([v for _, v in kvs])
        if kv_split is not None:
            T = xk.shape[2] // kv_split.n
            xk, xv = (t.narrow(2, kv_split.start(T), T) for t in (xk, xv))
    elif cache is None:
        raise ValueError("decode needs cached cross K/V: pass frames= or a cache")
    else:
        xk, xv = cache["xk"], cache["xv"]

    self_caches = (zip(cache["k"].unbind(0), cache["v"].unbind(0)) if cache is not None
                   else [None] * cfg.n_layers)
    for lp, xk_l, xv_l, kv in zip(layers, xk.unbind(0), xv.unbind(0), self_caches):
        block = functools.partial(_dec_block, cfg=cfg, pos0=pos0, self_cache=kv,
                                  parallel=parallel, kv_split=kv_split)
        x = _layer(block, remat)(x, lp, xk_l.to(x.dtype), xv_l.to(x.dtype))
    if cache is not None and frames is not None:
        cache["xk"].copy_(xk)
        cache["xv"].copy_(xv)
    return x, cache


def logits(cfg: ModelConfig, params: dict, hidden: torch.Tensor,
           parallel=None) -> torch.Tensor:
    """Hidden -> logits [B, S, V] (this rank's vocab columns under a vocab
    split over ``parallel``'s model axis)."""
    return ll.logits_from_hidden(params, hidden, cfg, parallel)


def layer_meta(cfg: ModelConfig) -> dict:
    return {}
