"""Mixture-of-Experts transformer (grok-1, qwen3-moe): the JAX package's
``models/moe.py`` on one device (its expert-parallel and
TP-within-expert branches wait for the sharded trainer).

Parameters keep the JAX package's names and layouts, ``w_down`` stored
``[L, E, d, ff]`` like ``w_gate``/``w_up``, so weights carry across with
``convert.params_from_repro`` unchanged.

The expert FFN is plain PyTorch (three einsums over the dispatch buffer),
as the JAX package computes it with XLA and no Pallas kernel.  Dispatch
is the capacity-factor scheme: the router's softmax in f32, the top-k
experts of each token (a stable descending sort, so ties go to the lower
expert index as ``lax.top_k`` sends them), slot-major flattening (every
token's first choice ahead of any second choice), positions within an
expert by a stable argsort, and ``cap = max(1, ceil(k*T/E * cf))`` rows an
expert; a row past its expert's capacity is dropped.

Capacity couples the tokens of one dispatch, so *which* tokens dispatch
together is part of the function.  ``forward(..., per_row_dispatch=False)``
dispatches all ``B x S`` tokens at once, as the JAX package's forward
does; ``per_row_dispatch=True`` dispatches each batch row alone (its own
``T = S`` and capacity) in one batched pass over a ``[B, E, cap, d]``
buffer, so the expert weights are still read once — what the JAX
package's serving gets by ``vmap``-ing a batch-1 forward over its slots.
The serving step builders read :data:`slot_decode_kwargs`.

The KV cache is the dense transformer's (:func:`init_cache`), written in
place.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as ll
from repro_torch.models import transformer as tf
from repro_torch.models.module import ParamDef, prefixed, unstack
from repro_torch.plan.planners import MoeFfnPlanner

# What the slot decode passes to forward: each slot dispatches alone.
slot_decode_kwargs = {"per_row_dispatch": True}


def param_defs(cfg: ModelConfig) -> dict:
    L, d, ff, E = cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.n_experts
    ep = E % 16 == 0  # expert-parallel vs TP-within-expert
    es = ll.MODEL_AXIS if ep else None
    espec = (None, es, None, None if ep else ll.ff_spec(ff))
    return {
        **ll.embed_defs(cfg),
        "layers/ln1": ParamDef((L, d), init="zeros"),
        "layers/ln2": ParamDef((L, d), init="zeros"),
        **prefixed("layers/attn", ll.attn_defs(cfg, L)),
        "layers/moe/router": ParamDef((L, d, E), fan_in_axis=1),
        "layers/moe/w_gate": ParamDef((L, E, d, ff), espec, fan_in_axis=2),
        "layers/moe/w_up": ParamDef((L, E, d, ff), espec, fan_in_axis=2),
        "layers/moe/w_down": ParamDef((L, E, d, ff), espec, fan_in_axis=3),
    }


def _top_k(probs: torch.Tensor, k: int):
    """(values, indices) of the k largest along the last axis, largest
    first, ties to the lower index (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(xg: torch.Tensor, router: torch.Tensor, cfg: ModelConfig):
    """The capacity dispatch of groups that route alone: ``xg`` [G, T, d]
    against the router [d, E].  Returns (slot, valid, gate_f, tok_f, cap):
    the slot-major rows' buffer row ``slot`` [G, kT] (``E * cap``, the
    overflow row, where ``valid`` is false: the row was dropped), their
    gates ``gate_f`` [G, kT], their tokens ``tok_f`` [kT], and the rows an
    expert takes, ``cap``."""
    G, T, _ = xg.shape
    E, k = cfg.n_experts, cfg.moe_top_k
    dev = xg.device

    probs = torch.softmax(xg.float() @ router.float(), -1)  # [G, T, E]
    gates, idx = _top_k(probs, k)  # [G, T, k]
    gates = gates / gates.sum(-1, keepdim=True)

    # Slot-major flattening: slot 0 (highest gate) gets capacity priority.
    idx_f = idx.transpose(1, 2).reshape(G, k * T)
    gate_f = gates.transpose(1, 2).reshape(G, k * T)
    tok_f = torch.arange(T, device=dev).repeat(k)

    cap = MoeFfnPlanner.expert_capacity(T, E, k, cfg.capacity_factor)
    # Position within the expert: a stable sort keeps row order inside
    # each expert, so a row's rank is its count of earlier same-expert rows.
    order = torch.argsort(idx_f, dim=-1, stable=True)
    sorted_e = torch.gather(idx_f, 1, order)
    starts = torch.searchsorted(sorted_e, torch.arange(E, device=dev).expand(G, E).contiguous())
    rank_sorted = torch.arange(k * T, device=dev) - torch.gather(starts, 1, sorted_e)
    pos_f = torch.zeros_like(idx_f).scatter_(1, order, rank_sorted)

    valid = pos_f < cap
    slot = torch.where(valid, idx_f * cap + pos_f, E * cap)
    return slot, valid, gate_f, tok_f, cap


def _moe_groups(xg: torch.Tensor, mp: dict, cfg: ModelConfig) -> torch.Tensor:
    """Token dispatch and the expert FFN for groups that dispatch alone.

    ``xg``: [G, T, d], each group's T tokens routed with the capacity of a
    T-token dispatch (:func:`_route`); ``mp``: the layer's router [d, E]
    and expert weights [E, d, ff].  Returns [G, T, d].  With G = 1 this is
    the JAX package's ``_moe_local`` on one device."""
    G, T, d = xg.shape
    E, k = cfg.n_experts, cfg.moe_top_k
    dev = xg.device
    slot, valid, gate_f, tok_f, cap = _route(xg, mp["router"], cfg)

    rows = E * cap + 1
    # Every valid slot is unique; the overflow row's value is thrown away,
    # so its duplicate writes may land in any order.
    flat = (torch.arange(G, device=dev)[:, None] * rows + slot).reshape(-1)
    src = xg[:, tok_f].reshape(G * k * T, d)
    buf = torch.zeros((G * rows, d), dtype=xg.dtype, device=dev).index_put((flat,), src)
    expert_in = buf.view(G, rows, d)[:, :-1].reshape(G, E, cap, d)

    cd = xg.dtype
    act = ll._ACT[cfg.act]
    h = act(torch.einsum("gecd,edf->gecf", expert_in, mp["w_gate"].to(cd))) * torch.einsum(
        "gecd,edf->gecf", expert_in, mp["w_up"].to(cd))
    h = torch.einsum("gecf,edf->gecd", h, mp["w_down"].to(cd))  # [G, E, cap, d]

    h_pad = torch.cat([h.reshape(G, E * cap, d), torch.zeros((G, 1, d), dtype=cd, device=dev)], 1)
    picked = torch.gather(h_pad, 1, slot[..., None].expand(G, k * T, d))
    y_rows = torch.where(valid[..., None], picked, torch.zeros((), dtype=cd, device=dev))
    return (gate_f[..., None].to(cd) * y_rows).reshape(G, k, T, d).sum(1)


def apply_moe_ffn(mp: dict, x: torch.Tensor, cfg: ModelConfig, *,
                  per_row_dispatch: bool = False) -> torch.Tensor:
    """x: [B, S, d] -> [B, S, d]: all B x S tokens in one dispatch, or each
    row in its own (``per_row_dispatch``)."""
    B, S, d = x.shape
    xg = x if per_row_dispatch else x.reshape(1, B * S, d)
    return _moe_groups(xg, mp, cfg).reshape(B, S, d)


def layer_meta(cfg: ModelConfig) -> dict:
    return tf.layer_meta(cfg)


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=torch.bfloat16, *,
               device=None) -> dict:
    return tf.init_cache(cfg, batch, max_seq, dtype, device=device)


def forward(cfg: ModelConfig, params: dict, tokens: torch.Tensor, *, pos0=0,
            cache: dict | None = None, compute_dtype=torch.float32, remat: str = "none",
            per_row_dispatch: bool = False):
    """Returns (hidden [B, S, d], cache).  ``pos0`` and ``cache`` as the
    dense transformer's (the cache written in place); ``remat="block"``
    recomputes each layer in the backward pass (the JAX package
    checkpoints its scan body under "block" alone); ``per_row_dispatch``
    as the module docstring says."""
    tf._check_remat(remat)
    x = ll.embed_tokens(params, tokens, cfg, compute_dtype)
    meta = layer_meta(cfg)
    caches = (zip(cache["k"].unbind(0), cache["v"].unbind(0)) if cache is not None
              else [None] * cfg.n_layers)

    def block(x, lp, window, theta, kv):
        h = ll.rms_norm(x, lp["ln1"], cfg.norm_eps)
        h, _ = ll.apply_attention(lp["attn"], h, cfg, pos0=pos0, window=window, theta=theta,
                                  cache=kv)
        x = x + h
        h = ll.rms_norm(x, lp["ln2"], cfg.norm_eps)
        return x + apply_moe_ffn(lp["moe"], h, cfg, per_row_dispatch=per_row_dispatch)

    for lp, window, theta, kv in zip(unstack(params, "layers", cfg.n_layers),
                                     meta["window"].tolist(), meta["theta"].tolist(), caches):
        x = tf._layer(block, remat)(x, lp, window, theta, kv)
    return x, cache


def logits(cfg: ModelConfig, params: dict, hidden: torch.Tensor) -> torch.Tensor:
    return ll.logits_from_hidden(params, hidden, cfg)
