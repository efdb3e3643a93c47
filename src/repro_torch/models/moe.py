"""Mixture-of-Experts transformer (grok-1, qwen3-moe): the JAX package's
``models/moe.py``, on one device and over a mesh's model axis.

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

On a mesh (``parallel=``, a ParallelCtx) the expert FFN is the JAX
package's ``shard_map`` of Alg 4 written as rank-local code: every rank
routes its data shard's tokens (``T_loc = B / dp * S``, and the capacity
of a ``T_loc``-token dispatch) redundantly from the replicated router and
keeps a private partial output ``[T_loc, d]``; one psum over the model
axis sums the partials.  The branch is the JAX package's, by ``E % 16``
(not ``E % tp``, which its docstring says):

* expert-parallel (``E % 16 == 0``, qwen3-moe): the rank owns experts
  ``[r * E / tp, (r + 1) * E / tp)`` and dispatches only the rows routed
  to them; a row bound for another rank's expert goes to the overflow row;
* TP-within-expert (grok-1, and the 4-expert smoke configs): every expert
  on every rank, on the rank's share of d_ff.

The router, and the hidden state entering the block, are replicated over
the model axis while each rank's gradient of them is partial, so both
enter through ``parallel.tp_enter`` (their backward sums over ``model``).
Attention, the embedding and the logits head run tensor-parallel as the
dense family's do (``models/layers.py``).
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as ll
from repro_torch.models import transformer as tf
from repro_torch.models.module import ParamDef, prefixed, unstack
from repro_torch.plan.planners import MoeFfnPlanner
from repro_torch.runtime import parallel as par

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


def _route(xg: torch.Tensor, router: torch.Tensor, cfg: ModelConfig,
           e_offset: int = 0, n_local: int | None = None):
    """The capacity dispatch of groups that route alone: ``xg`` [G, T, d]
    against the router [d, E], into the buffer of the ``n_local`` experts
    from ``e_offset`` on (default: all E).  Returns (slot, valid, gate_f,
    tok_f, cap): the slot-major rows' buffer row ``slot`` [G, kT]
    (``n_local * cap``, the overflow row, where ``valid`` is false: the
    row was dropped, or its expert is another rank's), their gates
    ``gate_f`` [G, kT], their tokens ``tok_f`` [kT], and the rows an
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

    n_local = E if n_local is None else n_local
    e_loc = idx_f - e_offset
    valid = (pos_f < cap) & (e_loc >= 0) & (e_loc < n_local)
    slot = torch.where(valid, e_loc * cap + pos_f, n_local * cap)
    return slot, valid, gate_f, tok_f, cap


def _moe_groups(xg: torch.Tensor, mp: dict, cfg: ModelConfig,
                e_offset: int = 0) -> torch.Tensor:
    """Token dispatch and the expert FFN for groups that dispatch alone.

    ``xg``: [G, T, d], each group's T tokens routed with the capacity of a
    T-token dispatch (:func:`_route`); ``mp``: the layer's router [d, E]
    and the expert weights [E_loc, d, ff] of experts ``e_offset`` on.
    Returns [G, T, d], the partial output of those experts.  With G = 1
    this is the JAX package's ``_moe_local``."""
    G, T, d = xg.shape
    k = cfg.moe_top_k
    E = mp["w_gate"].shape[0]  # the experts held here
    dev = xg.device
    slot, valid, gate_f, tok_f, cap = _route(xg, mp["router"], cfg, e_offset, E)

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


def expert_parallel(cfg: ModelConfig) -> bool:
    """The JAX package's branch rule: experts split over the model axis
    where ``E % 16 == 0``, else TP-within-expert."""
    return cfg.n_experts % 16 == 0


def local_moe_params(mp: dict, cfg: ModelConfig, parallel) -> tuple[dict, int]:
    """(this model rank's expert-FFN parameters, the first expert they
    hold): the router through ``tp_enter``; expert-parallel, its E / tp
    experts of each stack; TP-within-expert, every expert on its share of
    d_ff (``w_down`` is stored ``[E, d, ff]`` like the others)."""
    E, ff, tp = cfg.n_experts, cfg.d_ff, par.tp_size(parallel)
    ep = expert_parallel(cfg)
    n, dim = (E, 0) if ep else (ff, 2)
    if n % tp:
        raise ValueError(f"{'n_experts' if ep else 'd_ff'}={n} does not split over a model "
                         f"axis of {tp}")
    out = {"router": par.tp_enter(mp["router"], parallel)}
    for name in ("w_gate", "w_up", "w_down"):
        out[name] = par.tp_local(mp[name], dim, n, parallel)
    return out, (par.tp_rank(parallel) * (E // tp) if ep else 0)


def apply_moe_ffn(mp: dict, x: torch.Tensor, cfg: ModelConfig, *,
                  per_row_dispatch: bool = False, parallel=None) -> torch.Tensor:
    """x: [B, S, d] -> [B, S, d]: all B x S tokens in one dispatch, or each
    row in its own (``per_row_dispatch``).  With ``parallel`` (a model
    axis above 1) ``x`` is this rank's data shard, replicated over the
    model axis: each rank computes its experts' (or its d_ff share's)
    partial output and one psum over the model axis sums them."""
    B, S, d = x.shape
    xg = x if per_row_dispatch else x.reshape(1, B * S, d)
    if par.tp_size(parallel) == 1:
        return _moe_groups(xg, mp, cfg).reshape(B, S, d)
    mp, e_offset = local_moe_params(mp, cfg, parallel)
    y = _moe_groups(par.tp_enter(xg, parallel), mp, cfg, e_offset)
    return par.tp_exit(y, parallel).reshape(B, S, d)


def layer_meta(cfg: ModelConfig) -> dict:
    return tf.layer_meta(cfg)


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=torch.bfloat16, *,
               device=None, parallel=None) -> dict:
    return tf.init_cache(cfg, batch, max_seq, dtype, device=device, parallel=parallel)


def forward(cfg: ModelConfig, params: dict, tokens: torch.Tensor, *, pos0=0,
            cache: dict | None = None, compute_dtype=torch.float32, remat: str = "none",
            per_row_dispatch: bool = False, parallel=None, kv_split=None):
    """Returns (hidden [B, S, d], cache).  ``pos0`` and ``cache`` as the
    dense transformer's (the cache written in place); ``remat="block"``
    recomputes each layer in the backward pass (the JAX package
    checkpoints its scan body under "block" alone); ``per_row_dispatch``
    as the module docstring says.  With ``parallel`` the tokens are this
    rank's data shard, the parameters this rank's (or whole), a cache this
    rank's piece (``layers.cache_heads``; with ``kv_split``, its piece of
    the sequence), and every block runs over the model axis."""
    tf._check_remat(remat)
    x = ll.embed_tokens(params, tokens, cfg, compute_dtype, parallel)
    meta = layer_meta(cfg)
    caches = (zip(cache["k"].unbind(0), cache["v"].unbind(0)) if cache is not None
              else [None] * cfg.n_layers)

    def block(x, lp, window, theta, kv):
        h = ll.rms_norm(x, lp["ln1"], cfg.norm_eps)
        h, _ = ll.apply_attention(lp["attn"], h, cfg, pos0=pos0, window=window, theta=theta,
                                  cache=kv, parallel=parallel, kv_split=kv_split)
        x = x + h
        h = ll.rms_norm(x, lp["ln2"], cfg.norm_eps)
        return x + apply_moe_ffn(lp["moe"], h, cfg, per_row_dispatch=per_row_dispatch,
                                 parallel=parallel)

    for lp, window, theta, kv in zip(unstack(params, "layers", cfg.n_layers),
                                     meta["window"].tolist(), meta["theta"].tolist(), caches):
        x = tf._layer(block, remat)(x, lp, window, theta, kv)
    return x, cache


def logits(cfg: ModelConfig, params: dict, hidden: torch.Tensor,
           parallel=None) -> torch.Tensor:
    """Hidden -> logits [B, S, V] (this rank's vocab columns under a vocab
    split over ``parallel``'s model axis)."""
    return ll.logits_from_hidden(params, hidden, cfg, parallel)
