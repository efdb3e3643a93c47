"""Shared layer library: norms, RoPE, the GQA attention block with its KV
cache, MLPs, embeddings — the JAX package's ``models/layers.py`` without
its sharding branches.

Parameter layouts are the JAX package's: stacked-layer parameters carry a
leading L dim, and the attention projections stay 4D (``[d, H, Dh]`` and
``[H, Dh, d]``), so weights carry across unchanged.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import attention
from repro_torch.models.module import ParamDef

# --- norms -----------------------------------------------------------------


def rms_norm(x, w, eps=1e-6):
    xf = x.float()
    xf = xf * torch.rsqrt(torch.mean(xf * xf, -1, keepdim=True) + eps)
    return (xf * (1.0 + w.float())).to(x.dtype)


# --- RoPE ------------------------------------------------------------------


def rope(x, pos, theta):
    """x: [B, S, H, D]; pos: [S] integer positions, or [B, S] (one vector
    per row); theta: the base."""
    D = x.shape[-1]
    half = D // 2
    log_theta = torch.log(torch.tensor(float(theta), dtype=torch.float32))
    freq = torch.exp(-log_theta * torch.arange(half, dtype=torch.float32) / half)
    ang = pos.float()[..., None] * freq.to(pos.device)  # [(B,) S, half]
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1).to(x.dtype)


# --- attention block -------------------------------------------------------


def attn_defs(cfg: ModelConfig, L: int, layers_prefix: bool = True) -> dict:
    """Parameter defs for one GQA attention block, stacked over ``L``
    layers (or one unstacked block with ``layers_prefix=False``)."""
    d, Hq, Hkv, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    lead = (L,) if layers_prefix else ()
    fan = len(lead)
    defs = {
        "wq": ParamDef(lead + (d, Hq, Dh), fan_in_axis=fan),
        "wk": ParamDef(lead + (d, Hkv, Dh), fan_in_axis=fan),
        "wv": ParamDef(lead + (d, Hkv, Dh), fan_in_axis=fan),
        "wo": ParamDef(lead + (Hq, Dh, d), fan_in_axis=fan),
    }
    if cfg.qkv_bias:
        defs["bq"] = ParamDef(lead + (Hq, Dh), init="zeros")
        defs["bk"] = ParamDef(lead + (Hkv, Dh), init="zeros")
        defs["bv"] = ParamDef(lead + (Hkv, Dh), init="zeros")
    if cfg.qk_norm:
        defs["q_norm"] = ParamDef(lead + (Dh,), init="zeros")
        defs["k_norm"] = ParamDef(lead + (Dh,), init="zeros")
    return defs


def project_qkv(p: dict, x: torch.Tensor):
    """The block's three input projections: x [B, S, d] -> q, k, v [B, S, H, Dh]."""
    cd = x.dtype
    return tuple(torch.einsum("bsd,dhk->bshk", x, p[w].to(cd)) for w in ("wq", "wk", "wv"))


def project_out(p: dict, out: torch.Tensor) -> torch.Tensor:
    """The output projection: [B, S, Hq, Dh] -> [B, S, d]."""
    return torch.einsum("bshk,hkd->bsd", out, p["wo"].to(out.dtype))


def positions(pos0, batch: int, seq: int, device) -> torch.Tensor:
    """The absolute positions of a block of ``seq`` tokens that starts at
    ``pos0``: [seq] for an int, [batch, seq] for a tensor (one start per
    row; a 0-d tensor is one start for every row)."""
    offs = torch.arange(seq, dtype=torch.int32, device=device)
    if not isinstance(pos0, torch.Tensor):
        return pos0 + offs
    start = pos0.to(device=device, dtype=torch.int32).reshape(-1).expand(batch)
    return start[:, None] + offs


def write_cache(cache: tuple, k: torch.Tensor, v: torch.Tensor, pos0) -> None:
    """Write the block's K/V [B, S, Hkv, Dh] into the cache tensors (k, v)
    [B, Smax, Hkv, Dh] in place from ``pos0`` on (an int or 0-d tensor for
    every row, or a tensor with one start per row): the JAX package's
    ``dynamic_update_slice``, whose start is clamped to ``[0, Smax - S]``."""
    B, S = k.shape[:2]
    smax = cache[0].shape[1]
    start = torch.as_tensor(pos0, device=k.device).to(torch.int64).reshape(-1).expand(B)
    rows = torch.arange(B, device=k.device)[:, None]
    cols = start.clamp(0, smax - S)[:, None] + torch.arange(S, device=k.device)
    for c, new in zip(cache, (k, v)):
        c[rows, cols] = new.to(c.dtype)


def attention_core(p: dict, q, k, v, cfg: ModelConfig, *, pos0=0, window=None,
                   theta=None, causal: bool = True, cache: tuple | None = None
                   ) -> torch.Tensor:
    """Everything between the projections: biases, qk-norm, RoPE and
    attention; returns [B, S, Hq, Dh].

    ``pos0`` is the absolute position of the block's first token: an int,
    or a tensor [B] with one start per row.  With ``cache`` = (k, v)
    [B, Smax, Hkv, Dh] the roped K/V are written into it in place (see
    :func:`write_cache`) and the block attends over the whole cache with
    key positions ``arange(Smax)``: the causal mask hides what lies past
    each row's position."""
    B, S = q.shape[:2]
    Dh = cfg.resolved_head_dim
    theta = cfg.rope_theta if theta is None else theta
    cd = q.dtype
    if cfg.qkv_bias:
        q = q + p["bq"].to(cd)
        k = k + p["bk"].to(cd)
        v = v + p["bv"].to(cd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    q_pos = positions(pos0, B, S, q.device)
    q = rope(q, q_pos, theta)
    k = rope(k, q_pos, theta)
    if cache is None:
        return attention(q, k, v, q_pos=q_pos, k_pos=q_pos, causal=causal, window=window,
                         scale=Dh**-0.5)
    write_cache(cache, k, v, pos0)
    ck, cv = cache
    k_pos = torch.arange(ck.shape[1], dtype=torch.int32, device=q.device)
    return attention(q, ck.to(cd), cv.to(cd), q_pos=q_pos, k_pos=k_pos, causal=causal,
                     window=window, scale=Dh**-0.5)


def apply_attention(p: dict, x: torch.Tensor, cfg: ModelConfig, *, pos0=0, window=None,
                    theta=None, cache: tuple | None = None, causal: bool = True):
    """The attention block: x [B, S, d] -> (out [B, S, d], cache).  The
    projections, :func:`attention_core` and the output projection; with
    ``cache`` = (k, v) [B, Smax, Hkv, Dh] the block's K/V are written into
    it in place and the same tuple comes back (``None`` without one)."""
    q, k, v = project_qkv(p, x)
    o = attention_core(p, q, k, v, cfg, pos0=pos0, window=window, theta=theta,
                       causal=causal, cache=cache)
    return project_out(p, o), cache


# --- MLP -------------------------------------------------------------------

_ACT = {"silu": F.silu, "gelu": lambda x: F.gelu(x, approximate="tanh"),
        "relu": F.relu}


def mlp_defs(cfg: ModelConfig, L: int, d_ff: int | None = None) -> dict:
    d, ff = cfg.d_model, d_ff or cfg.d_ff
    return {
        "w_gate": ParamDef((L, d, ff), fan_in_axis=1),
        "w_up": ParamDef((L, d, ff), fan_in_axis=1),
        "w_down": ParamDef((L, ff, d), fan_in_axis=1),
    }


def apply_mlp(p: dict, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    """The gated MLP: act(x W_gate) * (x W_up), then W_down."""
    cd = x.dtype
    h = _ACT[act](x @ p["w_gate"].to(cd)) * (x @ p["w_up"].to(cd))
    return h @ p["w_down"].to(cd)


# --- embeddings ------------------------------------------------------------


def embed_defs(cfg: ModelConfig) -> dict:
    defs = {
        "embed": ParamDef((cfg.vocab, cfg.d_model), scale=1.0),
        "final_norm": ParamDef((cfg.d_model,), init="zeros"),
    }
    if not cfg.tie_embeddings:
        defs["w_out"] = ParamDef((cfg.d_model, cfg.vocab))
    return defs


def embed_tokens(p: dict, tokens: torch.Tensor, cfg: ModelConfig, dtype) -> torch.Tensor:
    x = p["embed"].to(dtype)[tokens.long()]
    if cfg.scale_embed:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=dtype)  # gemma-style scale
    return x


def ce_chunks(seq: int, loss_chunks: int) -> int:
    """The chunked cross-entropy's chunks per sequence: the largest divisor
    of ``seq`` that is at most ``loss_chunks``."""
    n = max(1, loss_chunks)
    while seq % n:
        n -= 1
    return n


def logits_from_hidden(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    x = rms_norm(x, p["final_norm"], cfg.norm_eps)
    if cfg.tie_embeddings:
        return torch.einsum("bsd,vd->bsv", x, p["embed"].to(x.dtype))
    return x @ p["w_out"].to(x.dtype)
