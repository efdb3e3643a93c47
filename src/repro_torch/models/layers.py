"""Shared layer library: norms, RoPE, the GQA attention block, MLPs,
embeddings — the JAX package's ``models/layers.py`` without its KV cache
and sharding branches.

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
    """x: [B, S, H, D]; pos: [S] integer positions; theta: the base."""
    D = x.shape[-1]
    half = D // 2
    log_theta = torch.log(torch.tensor(float(theta), dtype=torch.float32))
    freq = torch.exp(-log_theta * torch.arange(half, dtype=torch.float32) / half)
    ang = pos.float()[:, None] * freq.to(pos.device)[None, :]  # [S, half]
    cos = torch.cos(ang)[None, :, None, :]
    sin = torch.sin(ang)[None, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1).to(x.dtype)


# --- attention block -------------------------------------------------------


def attn_defs(cfg: ModelConfig, L: int) -> dict:
    """Parameter defs for one stacked GQA attention block."""
    d, Hq, Hkv, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    defs = {
        "wq": ParamDef((L, d, Hq, Dh), fan_in_axis=1),
        "wk": ParamDef((L, d, Hkv, Dh), fan_in_axis=1),
        "wv": ParamDef((L, d, Hkv, Dh), fan_in_axis=1),
        "wo": ParamDef((L, Hq, Dh, d), fan_in_axis=1),
    }
    if cfg.qkv_bias:
        defs["bq"] = ParamDef((L, Hq, Dh), init="zeros")
        defs["bk"] = ParamDef((L, Hkv, Dh), init="zeros")
        defs["bv"] = ParamDef((L, Hkv, Dh), init="zeros")
    if cfg.qk_norm:
        defs["q_norm"] = ParamDef((L, Dh), init="zeros")
        defs["k_norm"] = ParamDef((L, Dh), init="zeros")
    return defs


def apply_attention(p: dict, x: torch.Tensor, cfg: ModelConfig, *, pos0: int = 0,
                    window=None, theta=None, causal: bool = True) -> torch.Tensor:
    """One layer's attention block (no cache): x [B, S, d] -> [B, S, d]."""
    S = x.shape[1]
    Dh = cfg.resolved_head_dim
    theta = cfg.rope_theta if theta is None else theta
    cd = x.dtype
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(cd))
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"].to(cd))
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"].to(cd))
    if cfg.qkv_bias:
        q = q + p["bq"].to(cd)
        k = k + p["bk"].to(cd)
        v = v + p["bv"].to(cd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    q_pos = pos0 + torch.arange(S, dtype=torch.int32, device=x.device)
    q = rope(q, q_pos, theta)
    k = rope(k, q_pos, theta)
    out = attention(q, k, v, q_pos=q_pos, k_pos=q_pos, causal=causal, window=window,
                    scale=Dh**-0.5)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"].to(cd))


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
