"""Dense decoder-only transformer (qwen1.5 / qwen3 / gemma3 / chameleon):
the JAX package's ``models/transformer.py``.

Parameters are one flat ``{path: tensor}`` dict keyed like the JAX
package's nested tree (``"layers/attn/wq"``), with its stacked leading L
axis and layouts unchanged; the layer loop unbinds the stacks once.

The planned wing: ``forward(..., use_kernels=True,
schedules=plan_training(...))`` runs every GEMM of the block through the
planned ``fc_layer`` (the matmul kernel forward, the planned dX/dW kernels
backward) and the attention cell through the flash-attention kernel, whose
backward differentiates :func:`attention_ref` as the JAX package's does.
:class:`repro_torch.plan.TransformerBlockPlanner` owns the delegation
table (qkv/wo/mlp GEMMs -> MatmulPlanner, attn -> AttentionPlanner).

The KV cache (serving): :func:`init_cache` allocates ``{"k", "v"}`` of
``[L, B, Smax, Hkv, Dh]``, and ``forward(..., pos0=, cache=)`` writes each
layer's roped K/V into it *in place* at ``pos0`` and attends over it —
plain PyTorch, as the JAX package's cache path runs XLA and no kernel.
The cache passed in is the cache returned: a caller that needs the old
contents keeps a copy.

Rematerialization (``remat=``, both paths; ``torch.utils.checkpoint``,
non-reentrant, so the autograd graph and every gradient are the same bits
as without it):

* ``"none"`` keeps every activation autograd saves;
* ``"block"`` checkpoints each layer: only the layer's input is kept, and
  the backward pass runs the layer's forward again (on the planned path:
  its four GEMM launches and its flash launch);
* ``"dots"`` keeps the GEMMs' operands and results and recomputes the
  segments between GEMM calls — the norms, the residual adds, the biases,
  qk-norm, RoPE, attention (on the planned path a flash launch again) and
  the gated activation.  A layer keeps its input x, ``rms_norm(x)``, the
  q/k/v projections, the attention output, the output projection,
  ``rms_norm`` of the residual, the gate/up projections and the gated
  product, not the segments' internals (``repro``'s
  ``checkpoint_dots_with_no_batch_dims`` keeps the GEMM results alone;
  the port's GEMMs save their inputs for their own backward).

On a mesh (``parallel=``, a ParallelCtx whose model axis is above 1) both
paths run tensor-parallel over the model axis (``models/layers.py``):
each rank its share of the heads, of d_ff and of the vocab, at the local
shapes :func:`local_config` describes, which is also what the planned
path plans its kernels at (:func:`make_loss_fn`).  Query heads that do not
split over the model axis run sequence-parallel attention on both paths
(``layers.attention_split`` says ``"seq"``): each rank attends its slice
of the queries to every key, the planned path on the flash kernel with
the slice's query offset (``q_off``), and the slices are gathered.  The
plain path also serves on a mesh: with a KV cache each rank holds and
attends over its piece of it (``layers.cache_heads``, and its piece of
the sequence where the batch leaves data axes idle; the serving step
builders place it).
"""

from __future__ import annotations

import functools
import sys

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.fc_layer import fc_layer
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.models import layers as ll
from repro_torch.models.attention import seq_parallel
from repro_torch.models.module import ParamDef, unstack
from repro_torch.plan import local_schedule, with_reference_vjp
from repro_torch.runtime import parallel as par


def param_defs(cfg: ModelConfig) -> dict:
    L, d = cfg.n_layers, cfg.d_model
    defs = {
        **ll.embed_defs(cfg),
        "layers/ln1": ParamDef((L, d), (None, None), init="zeros"),
        "layers/ln2": ParamDef((L, d), (None, None), init="zeros"),
    }
    defs.update({f"layers/attn/{k}": v for k, v in ll.attn_defs(cfg, L).items()})
    defs.update({f"layers/mlp/{k}": v for k, v in ll.mlp_defs(cfg, L).items()})
    return defs


def layer_meta(cfg: ModelConfig) -> dict:
    """Per-layer (window, theta) tensors; window -1 means full attention."""
    L = cfg.n_layers
    idx = torch.arange(L)
    if cfg.global_every:
        is_global = (idx + 1) % cfg.global_every == 0
        window = torch.where(is_global, -1, cfg.local_window or -1)
        theta = torch.where(is_global, cfg.rope_theta_global or cfg.rope_theta,
                            cfg.rope_theta)
    else:
        window = torch.full((L,), cfg.local_window or -1)
        theta = torch.full((L,), cfg.rope_theta)
    return {"window": window.to(torch.int32), "theta": theta.to(torch.float32)}


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=torch.bfloat16, *,
               device=None, parallel=None) -> dict:
    """KV cache [L, B, Smax, Hkv, Dh] per tensor, zeros, on ``device``
    (default: the card); with ``parallel`` (a model axis above 1), the KV
    heads this model rank holds (``layers.cache_heads``)."""
    hkv = ll.cache_heads(cfg, parallel)[1] if par.tp_size(parallel) > 1 else cfg.n_kv_heads
    shape = (cfg.n_layers, batch, max_seq, hkv, cfg.resolved_head_dim)
    device = torch.device("cuda" if device is None else device)
    return {n: torch.zeros(shape, dtype=dtype, device=device) for n in ("k", "v")}


REMAT = ("none", "dots", "block")


def _check_remat(remat: str) -> None:
    if remat not in REMAT:
        raise ValueError(f"remat must be one of {REMAT}, got {remat!r}")


def _segment(fn, remat: str):
    """A stretch of a layer between GEMM calls: under ``remat="dots"`` it
    keeps only its inputs and runs again in the backward pass."""
    if remat != "dots":
        return fn
    return lambda *args: checkpoint(fn, *args, use_reentrant=False)


def _layer(fn, remat: str):
    """A whole layer: under ``remat="block"`` it keeps only its inputs and
    runs again in the backward pass."""
    if remat != "block":
        return fn
    return lambda *args: checkpoint(fn, *args, use_reentrant=False)


def forward(cfg: ModelConfig, params: dict, tokens: torch.Tensor, *, pos0=0,
            cache: dict | None = None, compute_dtype=torch.float32,
            use_kernels: bool = False, schedules: dict | None = None,
            remat: str = "none", parallel=None, kv_split=None):
    """Returns (hidden [B, S, d], new_cache).

    ``pos0`` is the absolute position of ``tokens[:, 0]``: an int, or
    (with a cache) a tensor [B] with one position per row (the serving
    engine's slots).
    With ``cache`` (from :func:`init_cache`) each layer writes its K/V into
    it in place and attends over the whole cache; the same dict comes back
    as ``new_cache`` (``None`` without a cache).

    ``use_kernels=True`` (training only: no cache, as in the JAX package)
    runs the planned wing: every projection GEMM through the planned
    ``fc_layer`` and the attention cell through the flash-attention
    kernel.  ``schedules`` maps cell names ("qkv", "attn", "wo", "mlp_up",
    "mlp_down") to explicit Schedules (from :func:`plan_forward`); backward
    pins ride in the same dict under "<cell>.dx"/"<cell>.dw" keys, which
    :func:`plan_training` emits — so autograd through this forward runs
    pinned planned backward kernels.  ``remat`` ("none" | "dots" |
    "block") trades memory for recompute (see the module docstring); with
    a cache it wraps the same segments, as the JAX package checkpoints its
    cached scan body.  ``parallel`` runs the layers
    tensor-parallel over its model axis on this rank's parameters (with a
    cache, this rank's piece of it: ``layers.cache_heads``); ``kv_split``
    (a SeqSplit) says the cache holds this rank's piece of the sequence
    (``layers.attention_core``)."""
    _check_remat(remat)
    if use_kernels and cache is None:
        return _forward_planned(cfg, params, tokens, compute_dtype, schedules,
                                remat, parallel), None
    x = ll.embed_tokens(params, tokens, cfg, compute_dtype, parallel)
    meta = layer_meta(cfg)
    caches = (zip(cache["k"].unbind(0), cache["v"].unbind(0)) if cache is not None
              else [None] * cfg.n_layers)
    for lp, window, theta, kv in zip(unstack(params, "layers", cfg.n_layers),
                                     meta["window"].tolist(), meta["theta"].tolist(), caches):
        x = _layer(lambda x, lp=lp, w=window, t=theta, kv=kv:
                   _block(x, lp, cfg, w, t, remat, pos0=pos0, cache=kv,
                          parallel=parallel, kv_split=kv_split), remat)(x)
    return x, cache


def _block(x, lp, cfg, window, theta, remat="none", *, pos0=0, cache=None,
           parallel=None, kv_split=None):
    """One plain layer, in segments between its GEMM calls; ``cache`` is
    the layer's (k, v) cache views, written in place.  With ``parallel``
    the attention and the MLP run over the model axis as
    ``layers.attention_split``/``layers.mlp_split`` say."""
    seg = functools.partial(_segment, remat=remat)
    ap, mp = lp["attn"], lp["mlp"]
    mode = ll.attention_split(cfg, x.shape[1], parallel, cached=cache is not None)
    h = seg(lambda x: ll.rms_norm(x, lp["ln1"], cfg.norm_eps))(x)
    if mode == "heads":
        ap, h = ll.local_attn_params(ap, cfg, parallel), par.tp_enter(h, parallel)
    q, k, v = ll.project_qkv(ap, h)
    seqp = parallel if mode == "seq" else None
    o = seg(lambda q, k, v: ll.attention_core(ap, q, k, v, cfg, pos0=pos0, window=window,
                                              theta=theta, cache=cache,
                                              parallel=seqp, kv_split=kv_split))(q, k, v)
    a = ll.project_out(ap, o)
    if mode == "heads":
        a = par.tp_exit(a, parallel)

    def residual_norm(x, a):
        x = x + a
        return x, ll.rms_norm(x, lp["ln2"], cfg.norm_eps)

    x, h = seg(residual_norm)(x, a)
    split = ll.mlp_split(cfg.d_ff, parallel)
    if split:
        mp, h = ll.local_mlp_params(mp, cfg.d_ff, parallel), par.tp_enter(h, parallel)
    cd = h.dtype
    g, u = h @ mp["w_gate"].to(cd), h @ mp["w_up"].to(cd)
    gated = seg(lambda g, u: ll._ACT[cfg.act](g) * u)(g, u)
    down = gated @ mp["w_down"].to(cd)
    return x + (par.tp_exit(down, parallel) if split else down)


def _bwd_for(sched: dict, cell: str) -> dict | None:
    """The backward-Schedule pins of one cell: ``{"qkv.dx": s}`` style keys
    (see :func:`plan_training`) become ``{"dx": s}``."""
    prefix = cell + "."
    out = {k[len(prefix):]: v for k, v in sched.items() if k.startswith(prefix)}
    return out or None


def _attn_kernel(q, k, v, causal, window, schedule, q_off=0):
    return flash_attention(q, k, v, causal=causal, window=window, schedule=schedule,
                           q_off=q_off)


def _attn_ref(q, k, v, causal, window, schedule, q_off=0):
    del schedule  # blocking never changes numerics
    return attention_ref(q, k, v, causal=causal, window=window, q_off=q_off)


def _attn_bwd(q, k, v, g, causal, window, schedule, q_off=0, *, needs):
    """The attention cell's backward: autograd of :func:`_attn_ref` (at the
    same query offset), recomputed here in plain PyTorch, as the JAX
    package leaves it to XLA (the flash kernel has no backward kernel)."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(n) for t, n in zip((q, k, v), needs)]
        out = _attn_ref(*leaves, causal, window, schedule, q_off)
        wanted = [t for t, n in zip(leaves, needs) if n]
        got = iter(torch.autograd.grad(out, wanted, g))
    return tuple(next(got) if n else None for n in needs)


# The planned attention cell: forward is the flash-attention kernel under
# its AttentionPlanner schedule, backward differentiates the reference;
# (causal, window, schedule, q_off) ride as plain values.
_attn_cell = with_reference_vjp(_attn_kernel, bwd_fn=_attn_bwd, nondiff_argnums=(3, 4, 5, 6))


def _attn_vjp(q, k, v, causal, window, schedule, q_off=0):
    return _attn_cell(q, k, v, causal, window, schedule, q_off)


def attn_rows(cfg: ModelConfig, seq: int, parallel=None) -> int:
    """The query rows one rank's planned attention cell takes: ``seq / tp``
    under sequence-parallel attention (``layers.attention_split`` says
    ``"seq"``), else ``seq``."""
    if ll.attention_split(cfg, seq, parallel) == "seq":
        return seq // par.tp_size(parallel)
    return seq


def check_planned_heads(cfg: ModelConfig, tp: int, seq: int) -> None:
    """The planned forward runs its attention over a model axis of ``tp``
    head-parallel, or sequence-parallel where the query heads do not split:
    raise where neither holds (heads that split without the KV heads they
    read, or a sequence that does not split for sequence-parallel
    attention)."""
    if tp == 1 or ll.heads_split(cfg, tp) or seq_parallel(seq, cfg.n_heads,
                                                          cfg.n_kv_heads, tp):
        return
    raise NotImplementedError(
        f"the planned forward over a model axis of {tp}: {cfg.n_heads} query heads "
        f"({cfg.n_kv_heads} KV heads) split neither by head nor, at seq {seq}, by "
        "sequence (ROADMAP queue 3 #22)")


def _forward_planned(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
                     compute_dtype, schedules: dict | None,
                     remat: str = "none", parallel=None) -> torch.Tensor:
    """The planned training forward: hidden [B, S, d].

    Cell decomposition mirrors ``TransformerBlockPlanner.cell_planners``:
    q/k/v fold into ONE ``[B*S, d] @ [d, (Hq+2*Hkv)*Dh]`` GEMM (one x
    stream for the three projections), gate+up into one ``[B*S, d] @
    [d, 2*ff]`` GEMM, and attention runs on the [B, H, S, D] layout the
    flash kernel takes.  Each layer attends at its own window and RoPE
    theta (:func:`layer_meta`: gemma3's local and global layers), one
    attention schedule serving both (its blocks do not depend on the
    window); the JAX package's planned forward refuses ``global_every``,
    whose windows its scanned block would carry traced.  With ``parallel``
    every cell runs at this rank's share of the heads and d_ff (the
    schedules planned at :func:`local_config`'s shapes), the attention
    head-parallel, or
    sequence-parallel where the query heads do not split
    (:func:`_seq_parallel_attend`, planned at :func:`attn_rows`).
    """
    sched = schedules or {}
    cd = compute_dtype
    tp = par.tp_size(parallel)
    check_planned_heads(cfg, tp, tokens.shape[1])
    x = ll.embed_tokens(params, tokens, cfg, cd, parallel)
    B, S, d = x.shape
    heads = tp > 1 and ll.heads_split(cfg, tp)  # else sequence-parallel attention
    lc = local_config(cfg, parallel)
    Hq, Hkv, Dh = lc.n_heads, lc.n_kv_heads, cfg.resolved_head_dim
    split = ll.mlp_split(cfg.d_ff, parallel)
    pos = torch.arange(S, dtype=torch.int32, device=x.device)
    s_attn = local_schedule(sched.get("attn"))
    seg = functools.partial(_segment, remat=remat)

    def layer(x, lp, window, theta):
        ap, mp = lp["attn"], lp["mlp"]
        if heads:
            ap = ll.local_attn_params(ap, cfg, parallel)
        if split:
            mp = ll.local_mlp_params(mp, cfg.d_ff, parallel)
        h = seg(lambda x: ll.rms_norm(x, lp["ln1"], cfg.norm_eps).reshape(B * S, d))(x)
        if heads:
            h = par.tp_enter(h, parallel)
        w_qkv = torch.cat([ap["wq"].reshape(d, Hq * Dh), ap["wk"].reshape(d, Hkv * Dh),
                           ap["wv"].reshape(d, Hkv * Dh)], dim=1).to(cd)
        qkv = fc_layer(h, w_qkv, sched.get("qkv"), _bwd_for(sched, "qkv"))

        def attend(qkv):
            q, k, v = torch.split(qkv, [Hq * Dh, Hkv * Dh, Hkv * Dh], dim=-1)
            q = q.reshape(B, S, Hq, Dh)
            k = k.reshape(B, S, Hkv, Dh)
            v = v.reshape(B, S, Hkv, Dh)
            if cfg.qkv_bias:
                q = q + ap["bq"].to(cd)
                k = k + ap["bk"].to(cd)
                v = v + ap["bv"].to(cd)
            if cfg.qk_norm:
                q = ll.rms_norm(q, ap["q_norm"], cfg.norm_eps)
                k = ll.rms_norm(k, ap["k_norm"], cfg.norm_eps)
            q = ll.rope(q, pos, theta)
            k = ll.rope(k, pos, theta)
            if tp == 1 or heads:
                o = _attn_vjp(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                              True, window, s_attn)
                return o.transpose(1, 2).reshape(B * S, Hq * Dh)
            return _seq_parallel_attend(q, k, v, window, s_attn, parallel).reshape(
                B * S, Hq * Dh)

        o = seg(attend)(qkv)
        wo = ap["wo"].reshape(Hq * Dh, d).to(cd)
        a = fc_layer(o, wo, sched.get("wo"), _bwd_for(sched, "wo"))
        if heads:
            a = par.tp_exit(a, parallel)

        def residual_norm(x, a):
            x = x + a.reshape(B, S, d)
            return x, ll.rms_norm(x, lp["ln2"], cfg.norm_eps).reshape(B * S, d)

        x, h = seg(residual_norm)(x, a)
        if split:
            h = par.tp_enter(h, parallel)
        w_gu = torch.cat([mp["w_gate"], mp["w_up"]], dim=1).to(cd)
        gu = fc_layer(h, w_gu, sched.get("mlp_up"), _bwd_for(sched, "mlp_up"))

        def gate(gu):
            g, u = torch.chunk(gu, 2, dim=-1)
            return ll._ACT[cfg.act](g) * u

        down = fc_layer(seg(gate)(gu), mp["w_down"].to(cd), sched.get("mlp_down"),
                        _bwd_for(sched, "mlp_down"))
        if split:
            down = par.tp_exit(down, parallel)
        return x + down.reshape(B, S, d)

    meta = layer_meta(cfg)
    for lp, window, theta in zip(unstack(params, "layers", cfg.n_layers),
                                 meta["window"].tolist(), meta["theta"].tolist()):
        x = _layer(functools.partial(layer, lp=lp, window=window if window >= 0 else None,
                                     theta=theta), remat)(x)
    return x


def _seq_parallel_attend(q, k, v, window, s_attn, parallel) -> torch.Tensor:
    """The planned attention cell sequence-parallel over the model axis:
    q/k/v [B, S, H, Dh] whole on every model rank; this rank's S / tp
    query rows (from ``q_off = rank * S / tp``) attend every key on the
    flash kernel, and the slices are gathered back to [B, S, Hq, Dh] —
    ``models/attention.py``'s sequence-parallel attention on the kernel."""
    from repro_torch.runtime import collectives as coll

    mesh, axis = parallel.mesh, parallel.tp_axis
    n = q.shape[1] // par.tp_size(parallel)
    q_l = coll.shard(q, (None, axis, None, None), mesh, axis)
    # Each rank's queries read all of K/V: their gradients are summed.
    k, v = par.tp_enter(k, parallel), par.tp_enter(v, parallel)
    o = _attn_vjp(q_l.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), True, window,
                  s_attn, par.tp_rank(parallel) * n)
    return coll.all_gather(o.transpose(1, 2), mesh, axis, dim=1)


def head_weight(cfg: ModelConfig, params: dict, parallel=None) -> torch.Tensor:
    """The logits head's [d, vocab] weight as the matmul kernels take it
    (this rank's vocab columns under a vocab split): the tied embedding
    transposed into one contiguous copy (its gradient reaches ``embed``
    through the copy).  Make it once per step and pass it to every
    :func:`logits` chunk."""
    w = ll.head_of(params, cfg, parallel)
    return w.t().contiguous() if cfg.tie_embeddings else w.contiguous()


def logits(cfg: ModelConfig, params: dict, hidden: torch.Tensor, *,
           schedules: dict | None = None, head: torch.Tensor | None = None,
           parallel=None):
    """Hidden -> [B, S, vocab] (this rank's vocab columns under a vocab
    split, ``layers.vocab_split``).  With a "logits" entry in ``schedules``
    (planned at the chunked-CE token-chunk size) the head runs the planned
    ``fc_layer`` GEMM on ``head`` (default :func:`head_weight`); backward
    pins ride under "logits.dx"/"logits.dw"."""
    sched = schedules or {}
    s = sched.get("logits")
    if s is None:
        return ll.logits_from_hidden(params, hidden, cfg, parallel)
    x = ll.rms_norm(hidden, params["final_norm"], cfg.norm_eps)
    if ll.vocab_split(cfg, parallel):
        x = par.tp_enter(x, parallel)
    B, S, d = x.shape
    w = head_weight(cfg, params, parallel) if head is None else head
    out = fc_layer(x.reshape(B * S, d), w.to(x.dtype), s, _bwd_for(sched, "logits"))
    return out.reshape(B, S, -1)


def _chunk_m(batch: int, seq: int, loss_chunks: int) -> int:
    """The logits GEMM's M: the rows of one of chunked_ce's token chunks."""
    return batch * (seq // ll.ce_chunks(seq, loss_chunks))


def local_config(cfg: ModelConfig, parallel=None) -> ModelConfig:
    """The config whose shapes one model rank computes under ``parallel``:
    its share of the query heads and the KV heads they read (head-parallel
    attention; query heads that do not split stay whole, the rank's
    attention cell then taking :func:`attn_rows` of the queries), of d_ff
    (a split MLP) and of the vocab (``vocab % tp``); the head dim stays the
    launched one.  The config itself on one device."""
    import dataclasses

    tp = par.tp_size(parallel)
    if tp == 1:
        return cfg
    changes = dict(head_dim=cfg.resolved_head_dim)
    if cfg.n_heads % tp == 0:
        changes.update(n_heads=cfg.n_heads // tp,
                       n_kv_heads=ll.kv_heads_of(cfg, parallel)[1])
    if ll.mlp_split(cfg.d_ff, parallel):
        changes.update(d_ff=cfg.d_ff // tp)
    if ll.vocab_split(cfg, parallel):
        changes.update(vocab=cfg.vocab // tp)
    return dataclasses.replace(cfg, **changes)


def plan_forward(cfg: ModelConfig, batch: int, seq: int, *, loss_chunks: int = 1,
                 in_bytes: int = 4, machine=None, mesh=None, shard_axis: str = "data",
                 autotune=None, seq_q: int | None = None) -> dict:
    """Plan every kernel launch of the planned :func:`forward` plus the
    :func:`logits` head, without running them: {cell: Schedule} keyed
    qkv/attn/wo/mlp_up/mlp_down/logits, each cell resolved through the
    autotune cache under ``autotune=`` like every other op.  Every cell is
    planned at the head dim the forward launches, ``resolved_head_dim``
    (the JAX package plans ``d_model // n_heads``; see
    ``TransformerBlockPlanner``).  The logits
    cell is planned at the chunk M that ``runtime.train.chunked_ce`` calls
    (``loss_chunks``).  With ``mesh=`` (a MeshSpec) every cell comes back
    as a ShardedSchedule over ``shard_axis``, the JAX package's
    ``plan_forward(mesh=)``.  ``seq_q`` (default ``seq``) is the attention
    cell's query rows, a rank's :func:`attn_rows` under sequence-parallel
    attention."""
    from repro_torch.core.machine import H100
    from repro_torch.plan import autotune as at
    from repro_torch.plan.planners import TransformerBlockPlanner

    machine = machine or H100
    cells = TransformerBlockPlanner(machine).cell_planners(
        batch=batch, seq=seq, d_model=cfg.d_model, n_heads=cfg.n_heads,
        d_ff=cfg.d_ff, n_kv_heads=cfg.n_kv_heads, in_bytes=in_bytes, causal=True,
        head_dim=cfg.resolved_head_dim, seq_q=seq_q)
    out = {name: at.resolve(planner.op, kw, machine=machine, mesh=mesh, axis=shard_axis,
                            policy=autotune)
           for name, (planner, kw) in cells.items()}
    out["logits"] = at.resolve(
        "matmul", dict(m=_chunk_m(batch, seq, loss_chunks), n=cfg.vocab,
                       k=cfg.d_model, in_bytes=in_bytes),
        machine=machine, mesh=mesh, axis=shard_axis, policy=autotune)
    return out


def plan_training(cfg: ModelConfig, batch: int, seq: int, *, loss_chunks: int = 1,
                  in_bytes: int = 4, machine=None, mesh=None, shard_axis: str = "data",
                  autotune=None, seq_q: int | None = None) -> dict:
    """:func:`plan_forward` plus every planned backward kernel autograd runs:
    "<cell>.dx"/"<cell>.dw" for each GEMM cell (the fused dX/dW kernel
    where it fits; the attention cell differentiates its reference and has
    no backward entries).  Pass the result via ``schedules=``."""
    from repro_torch.core import fc_layer as fl

    out = plan_forward(cfg, batch, seq, loss_chunks=loss_chunks, in_bytes=in_bytes,
                       machine=machine, mesh=mesh, shard_axis=shard_axis,
                       autotune=autotune, seq_q=seq_q)
    d, ff = cfg.d_model, cfg.d_ff
    Hq = cfg.n_heads
    Hkv = cfg.n_kv_heads or Hq
    Dh = cfg.resolved_head_dim
    m = batch * seq
    gemms = {
        "qkv": (m, d, (Hq + 2 * Hkv) * Dh),
        "wo": (m, Hq * Dh, d),
        "mlp_up": (m, d, 2 * ff),
        "mlp_down": (m, ff, d),
        "logits": (_chunk_m(batch, seq, loss_chunks), d, cfg.vocab),
    }
    for name, (mm, k, n) in gemms.items():
        for kk, s in fl.plan_bwd((mm, k), (k, n), in_bytes=in_bytes, machine=machine,
                                 mesh=mesh, shard_axis=shard_axis,
                                 autotune=autotune).items():
            out[f"{name}.{kk}"] = s
    return out


def make_loss_fn(cfg: ModelConfig, tcfg, parallel=None):
    """Family-registry hook: the dense-transformer training loss, chunked
    cross-entropy over :func:`forward` under ``tcfg.remat``.  Under
    ``tcfg.planned_kernels`` the
    whole step runs planned kernels — :func:`plan_training` pins every
    cell's Schedule (cached per (batch, seq)), the planned forward runs
    them, and ``chunked_ce`` routes its logits GEMM through the planned
    head on one contiguous head weight per step.  With ``parallel`` the
    batch is this rank's shard and the layers run tensor-parallel over the
    model axis; the plan is the data axis's "batch" partition at this
    rank's shapes: :func:`plan_training` of :func:`local_config` at the
    local batch, its attention cell at :func:`attn_rows`."""
    from repro_torch.runtime.train import chunked_ce

    dt = getattr(torch, tcfg.compute_dtype)
    fam = sys.modules[__name__]
    plans: dict[tuple[int, int], dict] = {}
    lcfg = local_config(cfg, parallel)

    def loss_fn(params, batch):
        tokens = batch["tokens"]
        if tcfg.planned_kernels:
            key = tuple(tokens.shape)
            if key not in plans:
                plans[key] = plan_training(lcfg, *key, loss_chunks=tcfg.loss_chunks,
                                           in_bytes=dt.itemsize,
                                           seq_q=attn_rows(cfg, key[1], parallel))
            h, _ = forward(cfg, params, tokens, compute_dtype=dt, use_kernels=True,
                           schedules=plans[key], remat=tcfg.remat, parallel=parallel)
            return chunked_ce(cfg, fam, params, h, batch["labels"], tcfg.loss_chunks,
                              schedules=plans[key],
                              head=head_weight(cfg, params, parallel), parallel=parallel)
        h, _ = forward(cfg, params, tokens, compute_dtype=dt, remat=tcfg.remat,
                       parallel=parallel)
        return chunked_ce(cfg, fam, params, h, batch["labels"], tcfg.loss_chunks,
                          parallel=parallel)

    return loss_fn
