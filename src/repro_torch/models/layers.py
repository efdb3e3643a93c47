"""Shared layer library: norms, RoPE, the GQA attention block with its KV
cache, MLPs, embeddings — the JAX package's ``models/layers.py``.

Parameter layouts are the JAX package's: stacked-layer parameters carry a
leading L dim, and the attention projections stay 4D (``[d, H, Dh]`` and
``[H, Dh, d]``), so weights carry across unchanged, and so do their
partition specs (``head_axis_spec``/``ff_spec`` pick the model axis by
divisibility at the production tp of 16, whatever the mesh).

Where the JAX package hints GSPMD, the port runs the blocks
tensor-parallel over the model axis itself (``parallel=`` a ParallelCtx
whose model axis is above 1), Megatron-style: the attention heads and the
MLP's d_ff split over the model ranks (column-parallel in, row-parallel
out, one psum), the vocab of the embedding and the logits head too.  Each
block takes its parameters as this rank holds them — the model axis's
share where the spec names it, else whole, in which case the block takes
its share by :func:`~repro_torch.runtime.parallel.tp_local`.  Query heads
that do not split over the model axis run sequence-parallel attention
(``models/attention.py``) under the JAX package's condition, else whole on
every rank.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import at_least_f32, attention, seq_parallel
from repro_torch.models.module import ParamDef
from repro_torch.runtime import parallel as par

MODEL_AXIS = "model"


def head_axis_spec(n_heads: int, head_dim: int, tp: int = 16):
    """(head_axis, dh_axis): shard heads if divisible, else replicate.
    Never head_dim (a Dh-sharded QK^T contraction psums every logits
    block); undividable query heads run sequence-parallel attention."""
    del head_dim
    if n_heads % tp == 0:
        return (MODEL_AXIS, None)
    return (None, None)


def ff_spec(d_ff: int, tp: int = 16):
    return MODEL_AXIS if d_ff % tp == 0 else None


# --- norms -----------------------------------------------------------------


def rms_norm(x, w, eps=1e-6):
    xf = at_least_f32(x)
    xf = xf * torch.rsqrt(torch.mean(xf * xf, -1, keepdim=True) + eps)
    return (xf * (1.0 + at_least_f32(w))).to(x.dtype)


def layer_norm(x, w, b, eps=1e-6):
    xf = at_least_f32(x)
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    xf = (xf - mu) * torch.rsqrt(var + eps)
    return (xf * at_least_f32(w) + at_least_f32(b)).to(x.dtype)


# --- RoPE ------------------------------------------------------------------


def rope(x, pos, theta):
    """x: [B, S, H, D]; pos: [S] integer positions, or [B, S] (one vector
    per row); theta: the base."""
    D = x.shape[-1]
    half = D // 2
    # The angles stay f32 in an f64 run (x goes f64), as the JAX package
    # defines them: with f64 angles, seamless-m4t-medium's f32 run over 4096
    # frame positions lies 0.28 of the logits' scale from the f64 one; with
    # f32 angles, 0.018 (H100).
    log_theta = torch.log(torch.tensor(float(theta), dtype=torch.float32))
    freq = torch.exp(-log_theta * torch.arange(half, dtype=torch.float32) / half)
    ang = pos.float()[..., None] * freq.to(pos.device)  # [(B,) S, half]
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = at_least_f32(x[..., :half]), at_least_f32(x[..., half:])
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1).to(x.dtype)


# --- attention block -------------------------------------------------------


def attn_defs(cfg: ModelConfig, L: int, layers_prefix: bool = True) -> dict:
    """Parameter defs for one GQA attention block, stacked over ``L``
    layers (or one unstacked block with ``layers_prefix=False``)."""
    d, Hq, Hkv, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    hs = head_axis_spec(Hq, Dh)
    khs = head_axis_spec(Hkv, Dh)
    lead = (L,) if layers_prefix else ()
    ls = (None,) if layers_prefix else ()
    fan = len(lead)
    defs = {
        "wq": ParamDef(lead + (d, Hq, Dh), ls + (None,) + hs, fan_in_axis=fan),
        "wk": ParamDef(lead + (d, Hkv, Dh), ls + (None,) + khs, fan_in_axis=fan),
        "wv": ParamDef(lead + (d, Hkv, Dh), ls + (None,) + khs, fan_in_axis=fan),
        "wo": ParamDef(lead + (Hq, Dh, d), ls + hs + (None,), fan_in_axis=fan),
    }
    if cfg.qkv_bias:
        defs["bq"] = ParamDef(lead + (Hq, Dh), ls + hs, init="zeros")
        defs["bk"] = ParamDef(lead + (Hkv, Dh), ls + khs, init="zeros")
        defs["bv"] = ParamDef(lead + (Hkv, Dh), ls + khs, init="zeros")
    if cfg.qk_norm:
        defs["q_norm"] = ParamDef(lead + (Dh,), ls + (None,), init="zeros")
        defs["k_norm"] = ParamDef(lead + (Dh,), ls + (None,), init="zeros")
    return defs


def attention_split(cfg: ModelConfig, seq: int, parallel, cached: bool = False) -> str:
    """How an attention block runs over the model axis: ``"heads"`` (each
    rank its share of the query heads and the KV heads they read),
    ``"seq"`` (no cache, the JAX package's sequence-parallel condition:
    query heads that do not split), or ``"whole"`` (every rank all of
    it)."""
    tp = par.tp_size(parallel)
    if tp == 1:
        return "whole"
    Hq, Hkv = cfg.n_heads, cfg.n_kv_heads
    if Hq % tp == 0:
        return "heads" if heads_split(cfg, tp) else "whole"
    return "seq" if not cached and seq_parallel(seq, Hq, Hkv, tp) else "whole"


def heads_split(cfg: ModelConfig, tp: int) -> bool:
    """Whether the query heads, with the KV heads they read, split over a
    model axis of ``tp``."""
    Hq, Hkv = cfg.n_heads, cfg.n_kv_heads
    if Hq % tp:
        return False
    hl, g = Hq // tp, Hq // Hkv
    return hl % g == 0 or g % hl == 0


def kv_heads_of(cfg: ModelConfig, parallel) -> tuple[int, int]:
    """(first, count) of the KV heads this model rank's query heads read."""
    Hq, Hkv = cfg.n_heads, cfg.n_kv_heads
    hl, g = Hq // par.tp_size(parallel), Hq // Hkv
    r = par.tp_rank(parallel)
    first = r * hl // g
    return first, ((r + 1) * hl - 1) // g + 1 - first


def cache_heads(cfg: ModelConfig, parallel) -> tuple[int, int]:
    """(first, count) of the KV heads a model rank's cache holds: the KV
    heads its query heads read where the heads split (an even share of
    them where ``parallel.kv_cache_spec`` splits the heads, else the
    shared heads, replicated), every KV head otherwise."""
    if attention_split(cfg, 1, parallel, cached=True) == "heads":
        return kv_heads_of(cfg, parallel)
    return 0, cfg.n_kv_heads


def local_attn_params(p: dict, cfg: ModelConfig, parallel) -> dict:
    """The attention block's parameters for this model rank's heads (under
    ``attention_split == "heads"``): its query heads of ``wq``/``bq``/``wo``
    and the KV heads they read of ``wk``/``wv``/``bk``/``bv``."""
    Hq, Hkv = cfg.n_heads, cfg.n_kv_heads
    k0, kn = kv_heads_of(cfg, parallel)
    out = {}
    for name, w in p.items():
        if name in ("wq", "bq"):
            out[name] = par.tp_local(w, w.ndim - 2, Hq, parallel)
        elif name == "wo":
            out[name] = par.tp_local(w, w.ndim - 3, Hq, parallel)
        elif name in ("wk", "wv", "bk", "bv"):
            dim = w.ndim - 2
            if w.shape[dim] == Hkv:
                w = par.tp_slice(w, dim, k0, kn, parallel)
            out[name] = w
        else:  # qk-norm weights span the head dim: each rank's heads add to them
            out[name] = par.tp_enter(w, parallel)
    return out


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


def write_cache(cache: tuple, k: torch.Tensor, v: torch.Tensor, pos0, kv_split=None) -> None:
    """Write the block's K/V [B, S, Hkv, Dh] into the cache tensors (k, v)
    [B, Smax, Hkv, Dh] in place from ``pos0`` on (an int or 0-d tensor for
    every row, or a tensor with one start per row): the JAX package's
    ``dynamic_update_slice``, whose start is clamped to ``[0, Smax - S]``.
    With ``kv_split`` the tensors are this rank's piece of a sequence of
    ``n * Smax`` split over its axes: the start is clamped for the whole
    sequence, then only the positions this piece holds are written."""
    B, S = k.shape[:2]
    piece = cache[0].shape[1]
    n = 1 if kv_split is None else kv_split.n
    s0 = 0 if kv_split is None else kv_split.start(piece)
    start = torch.as_tensor(pos0, device=k.device).to(torch.int64).reshape(-1).expand(B)
    rows = torch.arange(B, device=k.device)[:, None]
    cols = start.clamp(0, n * piece - S)[:, None] + torch.arange(S, device=k.device) - s0
    if kv_split is None:
        for c, new in zip(cache, (k, v)):
            c[rows, cols] = new.to(c.dtype)
        return
    mine = (cols >= 0) & (cols < piece)
    rows, cols = rows.expand(B, S)[mine], cols[mine]
    for c, new in zip(cache, (k, v)):
        c[rows, cols] = new[mine].to(c.dtype)


def attention_core(p: dict, q, k, v, cfg: ModelConfig, *, pos0=0, window=None,
                   theta=None, causal: bool = True, cache: tuple | None = None,
                   parallel=None, kv_split=None) -> torch.Tensor:
    """Everything between the projections: biases, qk-norm, RoPE and
    attention; returns [B, S, Hq, Dh].

    ``pos0`` is the absolute position of the block's first token: an int,
    or a tensor [B] with one start per row.  With ``cache`` = (k, v)
    [B, Smax, Hkv, Dh] the roped K/V are written into it in place (see
    :func:`write_cache`) and the block attends over the whole cache with
    key positions ``arange(Smax)``: the causal mask hides what lies past
    each row's position; the cache holds the KV heads of ``k``/``v``.
    With ``kv_split`` (a SeqSplit) the cache is this rank's piece of the
    sequence: the block writes the positions it holds and attends over its
    keys, and the pieces merge (``models/attention.py``).
    ``parallel`` (no cache) runs the attention sequence-parallel where the
    JAX package does."""
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
                         scale=Dh**-0.5, parallel=parallel)
    if cache[0].shape[2] != k.shape[2]:
        raise ValueError(f"a cache of {cache[0].shape[2]} KV heads for a block of "
                         f"{k.shape[2]} (a model rank's cache holds layers.cache_heads)")
    write_cache(cache, k, v, pos0, kv_split)
    ck, cv = cache
    k_pos = torch.arange(ck.shape[1], dtype=torch.int32, device=q.device)
    if kv_split is not None:
        k_pos = k_pos + kv_split.start(ck.shape[1])
    return attention(q, ck.to(cd), cv.to(cd), q_pos=q_pos, k_pos=k_pos, causal=causal,
                     window=window, scale=Dh**-0.5, kv_split=kv_split)


def apply_attention(p: dict, x: torch.Tensor, cfg: ModelConfig, *, pos0=0, window=None,
                    theta=None, cache: tuple | None = None, causal: bool = True,
                    parallel=None, kv_split=None):
    """The attention block: x [B, S, d] -> (out [B, S, d], cache).  The
    projections, :func:`attention_core` and the output projection; with
    ``cache`` = (k, v) [B, Smax, Hkv, Dh] the block's K/V are written into
    it in place and the same tuple comes back (``None`` without one).
    With ``parallel`` the block runs over the model axis as
    :func:`attention_split` says; a cache is then this rank's
    (:func:`cache_heads`), and with ``kv_split`` its piece of the sequence
    (:func:`attention_core`)."""
    mode = attention_split(cfg, x.shape[1], parallel, cached=cache is not None)
    if mode == "heads":
        p, x = local_attn_params(p, cfg, parallel), par.tp_enter(x, parallel)
    q, k, v = project_qkv(p, x)
    o = attention_core(p, q, k, v, cfg, pos0=pos0, window=window, theta=theta,
                       causal=causal, cache=cache,
                       parallel=parallel if mode == "seq" else None, kv_split=kv_split)
    out = project_out(p, o)
    return (par.tp_exit(out, parallel) if mode == "heads" else out), cache


# --- activations ------------------------------------------------------------
#
# Below f32 the JAX package's activations round at every primitive of their
# jaxprs, and XLA computes ``logistic`` as 1 / (1 + exp(-x)), each op
# rounded to x's dtype.  The port takes the same steps there, so a bf16
# forward rounds where ``repro``'s does; f32 and f64 keep PyTorch's fused
# functions (and their bits).


def _below_f32(x: torch.Tensor) -> bool:
    return x.dtype in (torch.bfloat16, torch.float16)


class _Logistic(torch.autograd.Function):
    """XLA's ``logistic`` below f32: 1 / (1 + exp(-x)) rounded op by op;
    the gradient is ``jax.nn.sigmoid``'s rule g * (y * (1 - y)) (autograd
    through the formula would give NaN where exp(-x) overflows)."""

    @staticmethod
    def forward(ctx, x):
        y = torch.reciprocal(1 + torch.exp(-x))
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return g * (y * (1 - y))


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid``: :class:`_Logistic` below f32, else torch.sigmoid."""
    return _Logistic.apply(x) if _below_f32(x) else torch.sigmoid(x)


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``: x * sigmoid(x), the sigmoid rounded to x's dtype
    before the product below f32 (its jaxpr: ``logistic``, then ``mul``)."""
    return x * sigmoid(x) if _below_f32(x) else F.silu(x)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu`` (tanh approximation).  Below f32 its jaxpr's steps,
    each rounded to x's dtype, its constants too (0.044715 and
    sqrt(2 / pi) become 0.044677734375 and 0.796875 in bf16)."""
    if not _below_f32(x):
        return F.gelu(x, approximate="tanh")
    c1, c2 = (torch.full((), c, dtype=x.dtype, device=x.device)
              for c in (0.044715, math.sqrt(2.0 / math.pi)))
    inner = (x + c1 * (x * x * x)) * c2
    return x * (0.5 * (1 + torch.tanh(inner)))


# --- MLP -------------------------------------------------------------------

_ACT = {"silu": silu, "gelu": gelu, "relu": F.relu}


def mlp_defs(cfg: ModelConfig, L: int, d_ff: int | None = None) -> dict:
    d, ff = cfg.d_model, d_ff or cfg.d_ff
    s = ff_spec(ff)
    return {
        "w_gate": ParamDef((L, d, ff), (None, None, s), fan_in_axis=1),
        "w_up": ParamDef((L, d, ff), (None, None, s), fan_in_axis=1),
        "w_down": ParamDef((L, ff, d), (None, s, None), fan_in_axis=1),
    }


def mlp_split(d_ff: int, parallel) -> bool:
    """Whether the MLP's d_ff splits over the model axis."""
    tp = par.tp_size(parallel)
    return tp > 1 and d_ff % tp == 0


def local_mlp_params(p: dict, d_ff: int, parallel) -> dict:
    """This model rank's share of d_ff: ``w_gate``/``w_up`` columns and
    ``w_down`` rows."""
    return {k: par.tp_local(w, w.ndim - (2 if k == "w_down" else 1), d_ff, parallel)
            for k, w in p.items()}


def apply_mlp(p: dict, x: torch.Tensor, act: str = "silu", parallel=None, *,
              d_ff: int | None = None) -> torch.Tensor:
    """The gated MLP: act(x W_gate) * (x W_up), then W_down.  With
    ``parallel`` and ``d_ff`` (the global width) splitting over the model
    axis: column-parallel in, row-parallel out, one psum."""
    split = d_ff is not None and mlp_split(d_ff, parallel)
    if split:
        p, x = local_mlp_params(p, d_ff, parallel), par.tp_enter(x, parallel)
    cd = x.dtype
    h = _ACT[act](x @ p["w_gate"].to(cd)) * (x @ p["w_up"].to(cd))
    out = h @ p["w_down"].to(cd)
    return par.tp_exit(out, parallel) if split else out


# --- embeddings ------------------------------------------------------------


def embed_defs(cfg: ModelConfig, tp: int = 16) -> dict:
    # Vocab-shard when divisible (most archs); else shard d_model
    # (seamless-m4t's 256206 vocab is not 16-divisible).
    if cfg.vocab % tp == 0:
        espec, ospec = (MODEL_AXIS, None), (None, MODEL_AXIS)
    elif cfg.d_model % tp == 0:
        espec, ospec = (None, MODEL_AXIS), (MODEL_AXIS, None)
    else:
        espec, ospec = (None, None), (None, None)
    defs = {
        "embed": ParamDef((cfg.vocab, cfg.d_model), espec, scale=1.0),
        "final_norm": ParamDef((cfg.d_model,), (None,), init="zeros"),
    }
    if not cfg.tie_embeddings:
        defs["w_out"] = ParamDef((cfg.d_model, cfg.vocab), ospec)
    return defs


def embed_whole_over_model(specs: dict) -> tuple:
    """The embedding leaves whose ``specs`` split d_model over the model
    axis: every model rank gathers them whole over it
    (:func:`embed_tokens`, :func:`head_of`)."""
    d_dim = {"embed": 1, "w_out": 0}
    return tuple(k for k, i in d_dim.items() if k in specs and specs[k][i] == MODEL_AXIS)


def vocab_split(cfg: ModelConfig, parallel) -> bool:
    """Whether the embedding and the logits head split the vocab over the
    model axis (Megatron's vocab-parallel embedding and cross-entropy)."""
    tp = par.tp_size(parallel)
    return tp > 1 and cfg.vocab % tp == 0


def embed_tokens(p: dict, tokens: torch.Tensor, cfg: ModelConfig, dtype,
                 parallel=None) -> torch.Tensor:
    """Token embeddings [B, S, d].  Under a vocab split each model rank
    looks up the tokens of its rows and one psum puts them together."""
    e = p["embed"]
    ids = tokens.long()
    if par.tp_size(parallel) > 1:
        e = par.tp_whole(e, 1, cfg.d_model, parallel)
    if vocab_split(cfg, parallel):
        e = par.tp_local(e, 0, cfg.vocab, parallel)
        rows = e.shape[0]
        local = ids - par.tp_rank(parallel) * rows
        mine = (local >= 0) & (local < rows)
        x = e.to(dtype)[local.clamp(0, rows - 1)]
        zero = torch.zeros((), dtype=dtype, device=x.device)
        x = par.tp_exit(torch.where(mine[..., None], x, zero), parallel)
    else:
        x = e.to(dtype)[ids]
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


def head_of(p: dict, cfg: ModelConfig, parallel=None) -> torch.Tensor:
    """The logits head as this rank uses it: ``embed`` [V, d] (tied) or
    ``w_out`` [d, V], whole over d_model, its vocab share under a vocab
    split, else whole."""
    w = p["embed"] if cfg.tie_embeddings else p["w_out"]
    if par.tp_size(parallel) == 1:
        return w
    d_dim, v_dim = (1, 0) if cfg.tie_embeddings else (0, 1)
    w = par.tp_whole(w, d_dim, cfg.d_model, parallel)
    return par.tp_local(w, v_dim, cfg.vocab, parallel) if vocab_split(cfg, parallel) else w


def logits_from_hidden(p: dict, x: torch.Tensor, cfg: ModelConfig,
                       parallel=None) -> torch.Tensor:
    """Hidden -> logits [B, S, V]; under a vocab split, this rank's
    [B, S, V / tp] columns."""
    x = rms_norm(x, p["final_norm"], cfg.norm_eps)
    if vocab_split(cfg, parallel):
        x = par.tp_enter(x, parallel)
    w = head_of(p, cfg, parallel)
    if cfg.tie_embeddings:
        return torch.einsum("bsd,vd->bsv", x, w.to(x.dtype))
    return x @ w.to(x.dtype)
