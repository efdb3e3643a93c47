"""Attention inside models (GQA, causal, sliding window): the JAX package's
``models/attention.py``.  It serves the plain forward; the planned forward
runs the flash-attention kernel.

When the query heads do not split over the model axis, the attention runs
*sequence-parallel* where the JAX package's does (:func:`seq_parallel`):
each model rank takes its slice of the query sequence against the whole
K/V, with no collective inside the softmax; the slices are gathered after.

Two execution paths, one math:

* ``direct`` — one materialized logits tensor, for decode (Sq == 1) and
  problems of up to 4M logits per head;
* ``blockwise`` — flash-style loop over query/KV chunks with running
  (m, l) statistics, O(chunk^2) live logits.

``window`` may be None, an int, or < 0 for "no window".

Positions are one vector ``[S]`` shared by every row, or ``[B, S]``, one
per row (the serving engine's slots decode at positions of their own; the
JAX package gets the same by ``vmap``-ing a batch-1 forward over them).

Over a KV cache whose sequence is split over idle data axes
(``kv_split=``, a :class:`~repro_torch.runtime.parallel.SeqSplit`) each
rank attends every query to its piece of the keys and keeps its softmax's
row max and row sum; the pieces merge in log-sum-exp form: a ``pmax`` of
the maxima, then one ``psum`` of the rescaled sums and outputs.  That is
the function GSPMD computes for the JAX package over the same placement,
up to f32 rounding.  Masked keys carry the additive ``NEG`` (never
``-inf``), so a rank whose keys are all masked adds exactly zero weight,
and a row with no visible key on any rank gets the uniform average over
every key, as the JAX package's softmax gives it.
"""

from __future__ import annotations

import torch

NEG = -1e30


def at_least_f32(x: torch.Tensor) -> torch.Tensor:
    """``x`` in float32, or as it is where it is float64 (an f64 run, such
    as an accuracy reference, stays f64 where the f32 path upcasts)."""
    return x if x.dtype == torch.float64 else x.float()


def _mask(q_pos, k_pos, causal, window):
    """Boolean visibility mask from positions: [Sq, Skv] for q_pos [Sq],
    [B, Sq, Skv] for q_pos [B, Sq]."""
    qp, kp = q_pos[..., :, None], k_pos[None, :]
    m = torch.ones(q_pos.shape + k_pos.shape, dtype=torch.bool, device=q_pos.device)
    if causal:
        m &= kp <= qp
    if window is not None and int(window) >= 0:
        m &= qp - kp < int(window)
    return m


def _bias(q_pos, k_pos, causal, window):
    """0 where visible, NEG where masked (f32): [Sq, Skv], or [B, 1, Sq, Skv]
    for positions per row (broadcast over the heads)."""
    zero = torch.zeros((), dtype=torch.float32, device=q_pos.device)
    bias = torch.where(_mask(q_pos, k_pos, causal, window), zero, zero + NEG)
    return bias[:, None] if q_pos.dim() == 2 else bias


def _direct(q, k, v, q_pos, k_pos, scale, causal, window, partial=False):
    s = torch.einsum("bhqd,bhkd->bhqk", at_least_f32(q), at_least_f32(k))
    s = s * scale + _bias(q_pos, k_pos, causal, window)
    if partial:
        m = s.amax(-1)
        p = torch.exp(s - m[..., None])
        acc = at_least_f32(torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype), v))
        return acc, m, p.sum(-1)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype), v)


def _blockwise(q, k, v, q_pos, k_pos, scale, causal, window, chunk_q, chunk_kv,
               partial=False):
    B, H, Sq, D = q.shape
    Skv = k.shape[2]
    cq, ckv = min(chunk_q, Sq), min(chunk_kv, Skv)
    if Sq % cq or Skv % ckv:
        raise ValueError(f"blockwise attention: ({Sq}, {Skv}) are not multiples "
                         f"of the chunks ({cq}, {ckv})")
    outs = []
    wide = torch.promote_types(q.dtype, torch.float32)
    for q0 in range(0, Sq, cq):
        qc, qpc = q[:, :, q0:q0 + cq], q_pos[..., q0:q0 + cq]
        acc = torch.zeros((B, H, cq, D), dtype=wide, device=q.device)
        m = torch.full((B, H, cq), NEG, dtype=wide, device=q.device)
        l = torch.zeros((B, H, cq), dtype=wide, device=q.device)
        for k0 in range(0, Skv, ckv):
            kc, vc = k[:, :, k0:k0 + ckv], v[:, :, k0:k0 + ckv]
            s = torch.einsum("bhqd,bhkd->bhqk", at_least_f32(qc), at_least_f32(kc))
            s = s * scale + _bias(qpc, k_pos[k0:k0 + ckv], causal, window)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + at_least_f32(torch.einsum(
                "bhqk,bhkd->bhqd", p.to(vc.dtype), vc))
            m = m_new
        if partial:
            outs.append((acc, m, l))
            continue
        l = torch.where(l == 0.0, torch.ones_like(l), l)  # fully-masked rows stay finite
        outs.append((acc / l[..., None]).to(q.dtype))
    if partial:
        return tuple(torch.cat(parts, dim=2) for parts in zip(*outs))
    return torch.cat(outs, dim=2)


def _attention_core(q, k, v, q_pos, k_pos, causal, window, scale, chunk_q, chunk_kv,
                    partial=False):
    """q: [B, Sq, Hq, D]; k/v: [B, Skv, Hkv, D] -> [B, Sq, Hq, D].  With
    ``partial`` it returns the softmax's pieces over these keys instead:
    the unnormalized output (at least f32) [B, Sq, Hq, D], the row max and
    the row sum [B, Sq, Hq]."""
    B, Sq, Hq, D = q.shape
    Hkv, Skv = k.shape[2], k.shape[1]
    if Hq % Hkv:
        raise ValueError(f"{Hkv} kv heads do not divide {Hq} query heads")
    g = Hq // Hkv
    # Fold the GQA group into the query-sequence axis so KV is never
    # repeated in memory: [B, Hkv, g*Sq, D] queries vs [B, Hkv, Skv, D] KV.
    qh = q.transpose(1, 2).reshape(B, Hkv, g * Sq, D)
    kh = k.transpose(1, 2)
    vh = v.transpose(1, 2)
    qpos_g = q_pos.repeat(g) if q_pos.dim() == 1 else q_pos.repeat(1, g)
    big = ((g * Sq) * Skv > 4 * 1024 * 1024 and (g * Sq) % chunk_q == 0
           and Skv % chunk_kv == 0)
    if Sq == 1 or not big:
        out = _direct(qh, kh, vh, qpos_g, k_pos, scale, causal, window, partial)
    else:
        out = _blockwise(qh, kh, vh, qpos_g, k_pos, scale, causal, window,
                         chunk_q, chunk_kv, partial)
    if partial:
        acc, m, l = out
        acc = acc.reshape(B, Hkv, g, Sq, D).permute(0, 3, 1, 2, 4).reshape(B, Sq, Hq, D)
        m, l = (t.reshape(B, Hkv, g, Sq).permute(0, 3, 1, 2).reshape(B, Sq, Hq)
                for t in (m, l))
        return acc, m, l
    out = out.reshape(B, Hkv, g, Sq, D).permute(0, 3, 1, 2, 4)
    return out.reshape(B, Sq, Hq, D).to(q.dtype)


def _split_kv_attention(q, k, v, q_pos, k_pos, causal, window, scale, chunk_q, chunk_kv,
                        split):
    """Attention of every query over a KV sequence split over ``split``'s
    axes, ``k``/``v``/``k_pos`` this rank's piece: the pieces' softmaxes
    merged by log-sum-exp (one ``pmax``, one ``psum``)."""
    from repro_torch.runtime import collectives as coll

    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "attention over a sequence-split KV cache is not differentiated (its "
            "merge's pmax has no gradient); it serves under torch.no_grad()")
    acc, m, l = _attention_core(q, k, v, q_pos, k_pos, causal, window, scale, chunk_q,
                                chunk_kv, partial=True)
    m_all = coll.pmax(m, split.mesh, split.axes)
    w = torch.exp(m - m_all)
    both = coll.psum(torch.cat([acc * w[..., None], (l * w)[..., None]], -1), split.mesh,
                     split.axes)
    return (both[..., :-1] / both[..., -1:]).to(q.dtype)


def seq_parallel(seq: int, n_heads: int, n_kv_heads: int, tp: int) -> bool:
    """The JAX package's condition for sequence-parallel attention: query
    heads that do not split over ``tp`` model ranks, a query sequence that
    does, and a local GQA-folded query block of a multiple of 8 rows."""
    return (seq > 1 and n_heads % tp != 0 and seq % tp == 0
            and (seq // tp) * (n_heads // n_kv_heads) % 8 == 0)


def attention(q, k, v, *, q_pos, k_pos, causal: bool = True, window=None,
              scale: float | None = None, chunk_q: int = 512,
              chunk_kv: int = 1024, parallel=None, kv_split=None) -> torch.Tensor:
    """GQA attention; q: [B, Sq, Hq, D], k/v: [B, Skv, Hkv, D] with
    positions q_pos [Sq] (or [B, Sq], one vector per row) and k_pos [Skv];
    returns [B, Sq, Hq, D].  With ``parallel`` (a ParallelCtx, every model
    rank holding the same q/k/v) and :func:`seq_parallel`, each model rank
    attends its query slice to the whole K/V and the slices are gathered:
    the same value, and the same gradients, on every rank.  With
    ``kv_split`` (a SeqSplit) k/v/k_pos are this rank's piece of a KV
    sequence split over its axes, and the pieces merge (module
    docstring)."""
    from repro_torch.runtime import collectives as coll
    from repro_torch.runtime import parallel as par

    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if kv_split is not None:
        return _split_kv_attention(q, k, v, q_pos, k_pos, causal, window, scale, chunk_q,
                                   chunk_kv, kv_split)
    B, Sq, Hq, _ = q.shape
    tp = par.tp_size(parallel)
    if not (tp > 1 and q_pos.dim() == 1 and seq_parallel(Sq, Hq, k.shape[2], tp)):
        return _attention_core(q, k, v, q_pos, k_pos, causal, window, scale,
                               chunk_q, chunk_kv)
    mesh, axis = parallel.mesh, parallel.tp_axis
    n = Sq // tp
    r = par.tp_rank(parallel)
    q_l = coll.shard(q, (None, axis, None, None), mesh, axis)
    # Each rank's queries read all of K/V: their gradients are summed.
    k, v = par.tp_enter(k, parallel), par.tp_enter(v, parallel)
    out = _attention_core(q_l, k, v, q_pos[r * n:(r + 1) * n], k_pos, causal, window,
                          scale, chunk_q, chunk_kv)
    return coll.all_gather(out, mesh, axis, dim=1)
