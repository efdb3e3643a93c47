"""Cell builder: (arch x shape x mesh) -> abstract inputs, their specs and
the step function, for the dry run and the roofline analysis; and the
sharding specs of a training state, as the JAX package's
``launch/specs.py`` builds them: FSDP/ZeRO specs of the parameters and the
moments, the parameter counts, the default training config of a cell.

Everything here is on the ``meta`` device: no weight, cache or batch is
allocated.  A :class:`Cell` holds one rank's operands of the step at the
rank's **local** shapes (each leaf's piece under its spec; the JAX
package's ``NamedSharding.shard_shape``), ``in_shardings`` the ``P`` specs
the JAX package's ``NamedSharding``s carry, and ``shapes`` the global
shapes.  The step functions are the port's own (``runtime/train.py``'s
``make_train_step``, ``runtime/serve.py``'s ``make_prefill_step`` and
``make_decode_step``); ``step_fn`` runs them on the rank's operands:

  * every rank of the port's steps takes the same global batch and cuts
    its rows itself, so ``step_fn`` hands the step the batch at its
    global shape (on ``meta`` that carries no data);
  * the serving parameters arrive as their FSDP shards, as the JAX
    package's cell places them, and ``step_fn`` gathers them over the
    data axes, the all-gather GSPMD runs for those specs;
  * a decode cache is the piece the port's builders make
    (``runtime/serve.py::_Mesh.init_cache``): where the port places a
    cache leaf otherwise than ``cache_specs`` (ROADMAP queue 3 #20-#21),
    its local shape is the port's.

The port computes in float32 at every size (ROADMAP queue 3 #3): a cell
keeps the JAX package's ``TrainConfig`` in ``meta`` unchanged (bf16
parameters for the large configs), but its tensors, cache and step run
f32.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.configs.registry import get_config, get_shape
from repro_torch.models import cnn
from repro_torch.models.module import abstract_params, count_params, flatten_defs, param_specs
from repro_torch.models.registry import get_family
from repro_torch.optim import adamw
from repro_torch.plan.sharded import P
from repro_torch.runtime import parallel as par
from repro_torch.runtime import serve as serve_rt
from repro_torch.runtime import train as train_rt
from repro_torch.runtime.parallel import ParallelCtx, batch_spec, cache_specs


@dataclasses.dataclass
class Cell:
    arch: str
    shape: str
    cfg: ModelConfig
    step_fn: Callable
    args: tuple  # one rank's operands on ``meta``, at its local shapes
    in_shardings: tuple  # the ``P`` specs of ``args``
    meta: dict[str, Any]
    shapes: tuple = ()  # the global shapes of ``args``


def shard_extra_axis(spec, shape: tuple, axes: tuple, mesh_shape: dict) -> P:
    """FSDP/ZeRO: add the data axes to the first unsharded divisible dim."""
    n = 1
    for a in axes:
        n *= mesh_shape[a]
    entries = list(spec) + [None] * (len(shape) - len(spec))
    for i, (e, dim) in enumerate(zip(entries, shape)):
        if e is None and dim % n == 0 and dim >= n:
            entries[i] = axes if len(axes) > 1 else axes[0]
            return P(*entries)
    return P(*entries)


def fsdp_specs(specs: dict, abstract: dict, ctx) -> dict:
    """``{path: P}``: each leaf's spec with the context's data axes added
    (:func:`shard_extra_axis`)."""
    mesh_shape = dict(ctx.mesh.shape)
    return {k: shard_extra_axis(s, tuple(abstract[k].shape), ctx.dp_axes, mesh_shape)
            for k, s in specs.items()}


def param_counts(cfg: ModelConfig, defs: dict) -> dict:
    """Total, embedding, and active (MoE-scaled) parameter counts."""
    total = count_params(defs)
    embed = 0
    moe_ffn = 0
    for path, d in flatten_defs(defs):
        if path.split("/")[-1] in ("embed", "w_out"):
            embed += math.prod(d.shape)
        if "/moe/w_" in path:
            moe_ffn += math.prod(d.shape)
    n_body = total - embed
    active = n_body
    if cfg.n_experts:
        active = n_body - moe_ffn + moe_ffn * cfg.moe_top_k // cfg.n_experts
    return {"total": total, "embed": embed, "body": n_body, "active": active}


def default_train_config(cfg: ModelConfig, global_batch: int, ctx) -> TrainConfig:
    """Microbatch: about 8 accumulation steps, divisible by the dp extent;
    bf16 parameters for the large configs."""
    micro = max(ctx.dp_size, global_batch // 8)
    while global_batch % micro:
        micro -= 1
    big = cfg.n_layers * cfg.d_model >= 64 * 4096
    return TrainConfig(
        param_dtype="bfloat16" if big else "float32",
        microbatch=micro,
        remat="block",
        loss_chunks=16,
    )


def local_shape(shape, spec, mesh_shape: dict) -> tuple:
    """One rank's piece of a ``shape`` under ``spec`` (each dimension
    over the product of the axes its entry names, rounded up as
    ``NamedSharding.shard_shape`` rounds)."""
    out = []
    for i, dim in enumerate(shape):
        e = spec[i] if i < len(spec) else None
        n = math.prod(mesh_shape[a] for a in par.spec_axes(e))
        out.append(-(-dim // n))
    return tuple(out)


def _tree_map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, adamw.AdamWState):
        return adamw.AdamWState(*(_tree_map(fn, getattr(tree, f), *(getattr(r, f) for r in rest))
                                  for f in ("step", "m", "v")))
    if isinstance(tree, train_rt.TrainState):
        return train_rt.TrainState(*(_tree_map(fn, getattr(tree, f), *(getattr(r, f) for r in rest))
                                     for f in ("params", "opt", "err")))
    if isinstance(tree, tuple) and not isinstance(tree, P):
        return tuple(_tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    return fn(tree, *rest)


def _local(tree, specs, ctx: ParallelCtx):
    """``tree``'s meta tensors cut to this rank's pieces under ``specs``."""
    mesh_shape = dict(ctx.mesh.shape)
    return _tree_map(lambda t, s: t if not isinstance(t, torch.Tensor) else torch.empty(
        local_shape(t.shape, s, mesh_shape), dtype=t.dtype, device="meta"), tree, specs)


def _shapes(tree):
    return _tree_map(lambda t: tuple(t.shape) if isinstance(t, torch.Tensor) else t, tree)


def _meta(shape, dtype=torch.float32) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _batch_struct(cfg: ModelConfig, kind: str, seq: int, batch: int,
                  tcfg: TrainConfig | None, ctx: ParallelCtx):
    """(abstract global batch, matching spec tree), as the JAX package
    builds them; frames are f32 here (the port computes f32)."""
    i32 = torch.int32
    if cfg.family == "cnn":
        n = batch // tcfg.microbatch if tcfg.microbatch else 1
        m = tcfg.microbatch or batch
        bs = batch_spec(ctx, m, 2)
        return (
            {"images": _meta((n, m, cnn.IMG, cnn.IMG, cnn.IN_CH)),
             "labels": _meta((n, m), i32)},
            {"images": P(None, bs[0], None, None, None), "labels": P(None, bs[0])},
        )
    if kind == "train":
        n = batch // tcfg.microbatch if tcfg.microbatch else 1
        m = tcfg.microbatch or batch
        if n > 1:
            shp, lead = (n, m, seq), (None,) + tuple(batch_spec(ctx, m, 1))
        else:
            shp, lead = (m, seq), tuple(batch_spec(ctx, m, 1))
        b = {"tokens": _meta(shp, i32), "labels": _meta(shp, i32)}
        s = {"tokens": P(*lead, None), "labels": P(*lead, None)}
        if cfg.family == "encdec":
            fs = (n, m, cfg.enc_seq, cfg.d_model) if n > 1 else (m, cfg.enc_seq, cfg.d_model)
            b["frames"] = _meta(fs)
            s["frames"] = P(*lead, None, None)
        return b, s
    # prefill
    b = {"tokens": _meta((batch, seq), i32)}
    s = {"tokens": batch_spec(ctx, batch, 2)}
    if cfg.family == "encdec":
        b["frames"] = _meta((batch, cfg.enc_seq, cfg.d_model))
        s["frames"] = P(*tuple(batch_spec(ctx, batch, 1)), None, None)
    return b, s


def _whole(batch: dict, shapes: dict) -> dict:
    """The batch at its global ``shapes``: every rank of the port's steps
    takes the global batch and cuts its own rows (on ``meta`` no data
    moves)."""
    return {k: torch.empty(shapes[k], dtype=v.dtype, device=v.device) for k, v in batch.items()}


def _gather_params(params: dict, specs: dict, ctx: ParallelCtx) -> dict:
    """FSDP-placed parameters gathered over the data axes (the layout the
    serving forward takes: split over ``model`` by ``param_specs``)."""
    return {k: par.gather_tensor(v, specs[k], ctx.mesh, ctx.dp_axes) for k, v in params.items()}


def build_cell(arch: str, shape_name: str, ctx: ParallelCtx,
               cfg: ModelConfig | None = None) -> Cell:
    """The cell of ``arch`` (``cfg``: another config of it, e.g. a smoke
    config) at shape ``shape_name`` on ``ctx``'s mesh."""
    cfg = cfg if cfg is not None else get_config(arch)
    shp = get_shape(shape_name)
    fam = get_family(cfg.family)

    defs = fam.param_defs(cfg)
    specs = param_specs(defs)
    counts = param_counts(cfg, defs)
    aparams = abstract_params(defs, torch.float32)
    pspecs = fsdp_specs(specs, aparams, ctx)

    if shp.kind == "train":
        tcfg = default_train_config(cfg, shp.global_batch, ctx)
        run_cfg = dataclasses.replace(tcfg, param_dtype="float32")
        astate = train_rt.TrainState(params=aparams, opt=adamw.abstract_state(aparams), err=None)
        sstate = train_rt.TrainState(params=pspecs,
                                     opt=adamw.AdamWState(step=P(), m=pspecs, v=pspecs),
                                     err=None)
        batch, bspecs = _batch_struct(cfg, "train", shp.seq_len, shp.global_batch, tcfg, ctx)
        # The cnn's step keeps its parameters and moments whole on every
        # rank (ROADMAP queue 3 #4); the token families take FSDP shards.
        fsdp = cfg.family != "cnn"
        step = train_rt.make_train_step(cfg, run_cfg, parallel=ctx,
                                        grad_specs=pspecs if fsdp else None)
        gshapes = _shapes(batch)

        def train_step(state, b):
            return step(state, _whole(b, gshapes))

        return Cell(arch, shape_name, cfg, train_step,
                    (_local(astate, sstate, ctx) if fsdp else astate,
                     _local(batch, bspecs, ctx)),
                    (sstate, bspecs),
                    {"counts": counts, "tcfg": tcfg, "kind": "train",
                     "tokens": shp.global_batch * shp.seq_len},
                    (_shapes(astate), gshapes))

    lparams = _local(aparams, pspecs, ctx)
    if shp.kind == "prefill":
        batch, bspecs = _batch_struct(cfg, "prefill", shp.seq_len, shp.global_batch, None, ctx)
        step = serve_rt.make_prefill_step(cfg, shp.seq_len, "float32", "float32",
                                          parallel=ctx)
        gshapes = _shapes(batch)

        def prefill_step(params, b):
            return step(_gather_params(params, pspecs, ctx), _whole(b, gshapes))

        return Cell(arch, shape_name, cfg, prefill_step, (lparams, _local(batch, bspecs, ctx)),
                    (pspecs, bspecs),
                    {"counts": counts, "kind": "prefill",
                     "tokens": shp.global_batch * shp.seq_len},
                    (_shapes(aparams), gshapes))

    # decode: one new token against a seq_len cache
    acache = fam.init_cache(cfg, shp.global_batch, shp.seq_len, torch.float32, device="meta")
    cspecs = cache_specs(ctx, acache)
    lcache = serve_rt._Mesh(cfg, ctx).init_cache(
        fam, shp.global_batch, shp.seq_len, torch.float32, "meta")
    tokens = _meta((shp.global_batch, 1), torch.int32)
    tspec = batch_spec(ctx, shp.global_batch, 2)
    step = serve_rt.make_decode_step(cfg, "float32", parallel=ctx)

    def decode_step(params, cache, tok, pos):
        return step(_gather_params(params, pspecs, ctx), cache,
                    _whole({"t": tok}, {"t": tuple(tokens.shape)})["t"], pos)

    return Cell(arch, shape_name, cfg, decode_step,
                (lparams, lcache, _local(tokens, tspec, ctx), _meta((), torch.int32)),
                (pspecs, cspecs, tspec, P()),
                {"counts": counts, "kind": "decode", "tokens": shp.global_batch},
                (_shapes(aparams), _shapes(acache), tuple(tokens.shape), ()))

