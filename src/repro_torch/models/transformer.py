"""Dense decoder-only transformer (qwen1.5 / qwen3 / gemma3 / chameleon),
training path: the JAX package's ``models/transformer.py`` without its KV
cache, rematerialization and sharding branches.

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
"""

from __future__ import annotations

import sys

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.fc_layer import fc_layer
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.models import layers as ll
from repro_torch.models.module import ParamDef
from repro_torch.plan import local_schedule, with_reference_vjp


def param_defs(cfg: ModelConfig) -> dict:
    L, d = cfg.n_layers, cfg.d_model
    defs = {
        **ll.embed_defs(cfg),
        "layers/ln1": ParamDef((L, d), init="zeros"),
        "layers/ln2": ParamDef((L, d), init="zeros"),
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


def _layers(params: dict, n_layers: int) -> list[dict]:
    """Per-layer nested parameter dicts ({"ln1", "attn": {...}, "mlp":
    {...}}) from the stacked leaves, each stack unbound once (so autograd
    stacks each gradient once)."""
    out = [{"attn": {}, "mlp": {}} for _ in range(n_layers)]
    for path, t in params.items():
        parts = path.split("/")
        if parts[0] != "layers":
            continue
        for lp, s in zip(out, t.unbind(0)):
            (lp[parts[1]] if len(parts) == 3 else lp)[parts[-1]] = s
    return out


def forward(cfg: ModelConfig, params: dict, tokens: torch.Tensor, *,
            compute_dtype=torch.float32, use_kernels: bool = False,
            schedules: dict | None = None):
    """Returns (hidden [B, S, d], None) — no KV cache on the training path.

    ``use_kernels=True`` runs the planned wing: every projection GEMM
    through the planned ``fc_layer`` and the attention cell through the
    flash-attention kernel.  ``schedules`` maps cell names ("qkv", "attn",
    "wo", "mlp_up", "mlp_down") to explicit Schedules (from
    :func:`plan_forward`); backward pins ride in the same dict under
    "<cell>.dx"/"<cell>.dw" keys, which :func:`plan_training` emits — so
    autograd through this forward runs pinned planned backward kernels."""
    if use_kernels:
        return _forward_planned(cfg, params, tokens, compute_dtype, schedules), None
    x = ll.embed_tokens(params, tokens, cfg, compute_dtype)
    meta = layer_meta(cfg)
    for lp, window, theta in zip(_layers(params, cfg.n_layers),
                                 meta["window"].tolist(), meta["theta"].tolist()):
        x = _block(x, lp, cfg, window, theta)
    return x, None


def _block(x, lp, cfg, window, theta):
    h = ll.rms_norm(x, lp["ln1"], cfg.norm_eps)
    x = x + ll.apply_attention(lp["attn"], h, cfg, window=window, theta=theta)
    h = ll.rms_norm(x, lp["ln2"], cfg.norm_eps)
    return x + ll.apply_mlp(lp["mlp"], h, cfg.act)


def _bwd_for(sched: dict, cell: str) -> dict | None:
    """The backward-Schedule pins of one cell: ``{"qkv.dx": s}`` style keys
    (see :func:`plan_training`) become ``{"dx": s}``."""
    prefix = cell + "."
    out = {k[len(prefix):]: v for k, v in sched.items() if k.startswith(prefix)}
    return out or None


def _attn_kernel(q, k, v, causal, window, schedule):
    return flash_attention(q, k, v, causal=causal, window=window, schedule=schedule)


def _attn_ref(q, k, v, causal, window, schedule):
    del schedule  # blocking never changes numerics
    return attention_ref(q, k, v, causal=causal, window=window)


def _attn_bwd(q, k, v, g, causal, window, schedule, *, needs):
    """The attention cell's backward: autograd of :func:`_attn_ref`,
    recomputed here in plain PyTorch, as the JAX package leaves it to XLA
    (the flash kernel has no backward kernel)."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(n) for t, n in zip((q, k, v), needs)]
        out = _attn_ref(*leaves, causal, window, schedule)
        wanted = [t for t, n in zip(leaves, needs) if n]
        got = iter(torch.autograd.grad(out, wanted, g))
    return tuple(next(got) if n else None for n in needs)


# The planned attention cell: forward is the flash-attention kernel under
# its AttentionPlanner schedule, backward differentiates the reference.
_attn_vjp = with_reference_vjp(_attn_kernel, bwd_fn=_attn_bwd, nondiff_argnums=(3, 4, 5))


def _forward_planned(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
                     compute_dtype, schedules: dict | None) -> torch.Tensor:
    """The planned training forward: hidden [B, S, d].

    Cell decomposition mirrors ``TransformerBlockPlanner.cell_planners``:
    q/k/v fold into ONE ``[B*S, d] @ [d, (Hq+2*Hkv)*Dh]`` GEMM (one x
    stream for the three projections), gate+up into one ``[B*S, d] @
    [d, 2*ff]`` GEMM, and attention runs on the [B, H, S, D] layout the
    flash kernel takes.  Per-layer windows (``global_every``) would need a
    schedule per layer and are refused.
    """
    if cfg.global_every:
        raise ValueError(
            "planned transformer forward needs one static attention window; "
            f"global_every={cfg.global_every} mixes per-layer windows (use the "
            "plain path)")
    sched = schedules or {}
    cd = compute_dtype
    x = ll.embed_tokens(params, tokens, cfg, cd)
    B, S, d = x.shape
    Hq, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    pos = torch.arange(S, dtype=torch.int32, device=x.device)
    window = cfg.local_window or None
    s_attn = local_schedule(sched.get("attn"))

    for lp in _layers(params, cfg.n_layers):
        ap, mp = lp["attn"], lp["mlp"]
        h = ll.rms_norm(x, lp["ln1"], cfg.norm_eps)
        w_qkv = torch.cat([ap["wq"].reshape(d, Hq * Dh), ap["wk"].reshape(d, Hkv * Dh),
                           ap["wv"].reshape(d, Hkv * Dh)], dim=1).to(cd)
        qkv = fc_layer(h.reshape(B * S, d), w_qkv, sched.get("qkv"),
                       _bwd_for(sched, "qkv"))
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
        q = ll.rope(q, pos, cfg.rope_theta)
        k = ll.rope(k, pos, cfg.rope_theta)
        o = _attn_vjp(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                      True, window, s_attn)
        o = o.transpose(1, 2).reshape(B * S, Hq * Dh)
        wo = ap["wo"].reshape(Hq * Dh, d).to(cd)
        x = x + fc_layer(o, wo, sched.get("wo"), _bwd_for(sched, "wo")).reshape(B, S, d)
        h = ll.rms_norm(x, lp["ln2"], cfg.norm_eps)
        w_gu = torch.cat([mp["w_gate"], mp["w_up"]], dim=1).to(cd)
        gu = fc_layer(h.reshape(B * S, d), w_gu, sched.get("mlp_up"),
                      _bwd_for(sched, "mlp_up"))
        g, u = torch.chunk(gu, 2, dim=-1)
        down = fc_layer(ll._ACT[cfg.act](g) * u, mp["w_down"].to(cd),
                        sched.get("mlp_down"), _bwd_for(sched, "mlp_down"))
        x = x + down.reshape(B, S, d)
    return x


def head_weight(cfg: ModelConfig, params: dict) -> torch.Tensor:
    """The logits head's [d, vocab] weight as the matmul kernels take it:
    the tied embedding transposed into one contiguous copy (its gradient
    reaches ``embed`` through the copy).  Make it once per step and pass
    it to every :func:`logits` chunk."""
    if cfg.tie_embeddings:
        return params["embed"].t().contiguous()
    return params["w_out"].contiguous()


def logits(cfg: ModelConfig, params: dict, hidden: torch.Tensor, *,
           schedules: dict | None = None, head: torch.Tensor | None = None):
    """Hidden -> [B, S, vocab].  With a "logits" entry in ``schedules``
    (planned at the chunked-CE token-chunk size) the head runs the planned
    ``fc_layer`` GEMM on ``head`` (default :func:`head_weight`); backward
    pins ride under "logits.dx"/"logits.dw"."""
    sched = schedules or {}
    s = sched.get("logits")
    if s is None:
        return ll.logits_from_hidden(params, hidden, cfg)
    x = ll.rms_norm(hidden, params["final_norm"], cfg.norm_eps)
    B, S, d = x.shape
    w = head_weight(cfg, params) if head is None else head
    out = fc_layer(x.reshape(B * S, d), w.to(x.dtype), s, _bwd_for(sched, "logits"))
    return out.reshape(B, S, -1)


def _chunk_m(batch: int, seq: int, loss_chunks: int) -> int:
    """The logits GEMM's M: the rows of one of chunked_ce's token chunks."""
    return batch * (seq // ll.ce_chunks(seq, loss_chunks))


def plan_forward(cfg: ModelConfig, batch: int, seq: int, *, loss_chunks: int = 1,
                 in_bytes: int = 4, machine=None) -> dict:
    """Plan every kernel launch of the planned :func:`forward` plus the
    :func:`logits` head, without running them: {cell: Schedule} keyed
    qkv/attn/wo/mlp_up/mlp_down/logits.  The logits cell is planned at the
    chunk M that ``runtime.train.chunked_ce`` calls (``loss_chunks``)."""
    from repro_torch.core.machine import H100
    from repro_torch.plan.planners import MatmulPlanner, TransformerBlockPlanner

    machine = machine or H100
    cells = TransformerBlockPlanner(machine).cell_planners(
        batch=batch, seq=seq, d_model=cfg.d_model, n_heads=cfg.n_heads,
        d_ff=cfg.d_ff, n_kv_heads=cfg.n_kv_heads, in_bytes=in_bytes, causal=True)
    out = {name: planner.plan(**kw) for name, (planner, kw) in cells.items()}
    out["logits"] = MatmulPlanner(machine).plan(
        m=_chunk_m(batch, seq, loss_chunks), n=cfg.vocab, k=cfg.d_model,
        in_bytes=in_bytes)
    return out


def plan_training(cfg: ModelConfig, batch: int, seq: int, *, loss_chunks: int = 1,
                  in_bytes: int = 4, machine=None) -> dict:
    """:func:`plan_forward` plus every planned backward kernel autograd runs:
    "<cell>.dx"/"<cell>.dw" for each GEMM cell (the fused dX/dW kernel
    where it fits; the attention cell differentiates its reference and has
    no backward entries).  Pass the result via ``schedules=``."""
    from repro_torch.core import fc_layer as fl

    out = plan_forward(cfg, batch, seq, loss_chunks=loss_chunks, in_bytes=in_bytes,
                       machine=machine)
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
        for kk, s in fl.plan_bwd((mm, k), (k, n), in_bytes=in_bytes,
                                 machine=machine).items():
            out[f"{name}.{kk}"] = s
    return out


def make_loss_fn(cfg: ModelConfig, tcfg):
    """Family-registry hook: the dense-transformer training loss, chunked
    cross-entropy over :func:`forward`.  Under ``tcfg.planned_kernels`` the
    whole step runs planned kernels — :func:`plan_training` pins every
    cell's Schedule (cached per (batch, seq)), the planned forward runs
    them, and ``chunked_ce`` routes its logits GEMM through the planned
    head on one contiguous head weight per step."""
    from repro_torch.runtime.train import chunked_ce

    dt = getattr(torch, tcfg.compute_dtype)
    fam = sys.modules[__name__]
    plans: dict[tuple[int, int], dict] = {}

    def loss_fn(params, batch):
        tokens = batch["tokens"]
        if tcfg.planned_kernels:
            key = tuple(tokens.shape)
            if key not in plans:
                plans[key] = plan_training(cfg, *key, loss_chunks=tcfg.loss_chunks,
                                           in_bytes=dt.itemsize)
            h, _ = forward(cfg, params, tokens, compute_dtype=dt, use_kernels=True,
                           schedules=plans[key])
            return chunked_ce(cfg, fam, params, h, batch["labels"], tcfg.loss_chunks,
                              schedules=plans[key], head=head_weight(cfg, params))
        h, _ = forward(cfg, params, tokens, compute_dtype=dt)
        return chunked_ce(cfg, fam, params, h, batch["labels"], tcfg.loss_chunks)

    return loss_fn
