"""The paper's own domain: a CNN built from core.conv_layer and
core.fc_layer (VGG-style conv/pool stages + two FC layers), forward and
planned backward, with the family-registry hooks a trainer calls
(``data_source``, ``make_loss_fn``, ``plan_training``, ``batch_shard_specs``).

Config reuse: ``n_layers`` = conv stages, ``d_model`` = base channel width
(doubled per stage), ``d_ff`` = FC hidden width, ``vocab`` = classes.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.machine import H100
from repro_torch.core.conv_layer import conv_block
from repro_torch.core.fc_layer import fc_layer
from repro_torch.kernels.conv2d.ref import conv2d_fused_ref
from repro_torch.models.module import ParamDef
from repro_torch.plan.sharded import P

IMG = 32  # input resolution (CIFAR-like)
IN_CH = 3
F = 3  # receptive field of every conv filter (the paper's running F)


def _stage_channels(cfg: ModelConfig) -> list[tuple[int, int]]:
    chans, c_in = [], IN_CH
    for i in range(cfg.n_layers):
        c_out = cfg.d_model * (2**i)
        chans.append((c_in, c_out))
        c_in = c_out
    return chans


def _stage_geometry(cfg: ModelConfig, batch: int):
    """Every stage's operand shapes: yields ``(name, x_shape, w_shape)`` for
    each conv stage (halving the plane per 2x2 pool) and each FC stage."""
    H = IMG
    for i, (ci, co) in enumerate(_stage_channels(cfg)):
        yield f"conv{i}", (batch, H, H, ci), (F, F, ci, co)
        H //= 2
    flat = H * H * cfg.d_model * (2 ** (cfg.n_layers - 1))
    yield "fc1", (batch, flat), (flat, cfg.d_ff)
    yield "fc2", (batch, cfg.d_ff), (cfg.d_ff, cfg.vocab)


def param_defs(cfg: ModelConfig) -> dict:
    defs = {}
    for name, _x_shape, w_shape in _stage_geometry(cfg, batch=1):
        if name.startswith("conv"):
            i = name[len("conv"):]
            defs[name] = ParamDef(w_shape, fan_in_axis=2)
            defs[f"bias{i}"] = ParamDef((w_shape[3],), init="zeros")
        else:
            spec = (None, "model") if name == "fc1" else ("model", None)
            defs[name] = ParamDef(w_shape, spec)
            defs[f"{name}_b"] = ParamDef((w_shape[1],), init="zeros")
    return defs


def batch_shard_specs(dp) -> dict:
    """Family-registry hook: how this family's batch shards over the data
    axes (``dp`` is an axis name or tuple).  Images shard their batch
    dimension — the "batch" partition the mesh-aware ConvPlanner emits for
    every conv stage — so the trainer needs no family special-casing."""
    return {"images": P(dp, None, None, None), "labels": P(dp)}


def data_source(cfg: ModelConfig, batch: int, shard, seed: int = 0):
    """Family-registry hook: this family trains on image/label batches."""
    from repro_torch.data.pipeline import SyntheticImageSource

    return SyntheticImageSource(IMG, IN_CH, cfg.vocab, batch, shard, seed=seed)


def make_loss_fn(cfg: ModelConfig, tcfg, parallel=None):
    """Family-registry hook: image-classification cross-entropy over
    :func:`forward`.  Under ``tcfg.planned_kernels`` the step runs the full
    planned set — the fused forward kernels plus the planned dgrad/wgrad/
    dX/dW backward kernels, every Schedule pinned by :func:`plan_training`
    (cached per batch size; an accumulated step plans at the micro-batch's
    size, under the process's autotune policy).  ``batch`` holds tensors on
    the compute device.  The CNN has no rematerialization, as in the JAX
    package: ``tcfg.remat`` does not apply.

    With ``parallel`` (a ``runtime.parallel.ParallelCtx``) ``batch`` is this
    rank's shard of the data axis (``runtime.parallel.data_axis``) and the
    schedules are the data-parallel plan: ``plan_training`` of the global
    batch over that axis with every stage's "batch" partition pinned, whose
    local schedules are planned at the shard's shapes."""
    dt = getattr(torch, tcfg.compute_dtype)
    plans: dict[int, dict] = {}

    def plan(B: int, in_bytes: int) -> dict:
        if parallel is None:
            return plan_training(cfg, B, in_bytes=in_bytes)
        from repro_torch.runtime.parallel import data_axis

        axis = data_axis(parallel)
        return plan_training(cfg, B * parallel.mesh.shape[axis], in_bytes=in_bytes,
                             mesh=parallel.plan_mesh(), shard_axis=axis,
                             shard_strategy="batch")

    def loss_fn(params, batch):
        imgs = batch["images"].to(dt)
        if tcfg.planned_kernels:
            B = imgs.shape[0]
            if B not in plans:
                plans[B] = plan(B, imgs.element_size())
            out = forward(cfg, params, imgs, use_kernels=True, schedules=plans[B])
        else:
            out = forward(cfg, params, imgs, use_kernels=False)
        out = out.float()
        lse = torch.logsumexp(out, -1)
        tgt = out.gather(-1, batch["labels"].long()[:, None])[:, 0]
        return (lse - tgt).mean()

    return loss_fn


def _bwd_for(sched: dict, stage: str) -> dict | None:
    """The backward-Schedule pins of one stage: ``{"conv0.dgrad": s}``
    style keys (see :func:`plan_training`) become ``{"dgrad": s}``."""
    prefix = stage + "."
    out = {k[len(prefix):]: v for k, v in sched.items() if k.startswith(prefix)}
    return out or None


def forward(cfg: ModelConfig, params: dict, images: torch.Tensor, *,
            use_kernels: bool = True, schedules: dict | None = None) -> torch.Tensor:
    """images: [B, IMG, IMG, 3] -> logits [B, classes].

    With ``use_kernels`` every conv stage is one fused conv + bias + ReLU +
    2x2 max-pool (the direct kernel, or the im2col GEMM where its schedule
    says so) and fc1/fc2 run the matmul kernel; ``schedules`` maps stage
    names ("conv0", ..., "fc1", "fc2") to explicit Schedules (e.g. from
    :func:`plan_forward`).  Backward pins ride in the same dict under
    "<stage>.dgrad"/"<stage>.wgrad" (conv; plus "<stage>.recompute" on
    ragged geometries) and "<stage>.dx"/"<stage>.dw" (FC) keys —
    :func:`plan_training` emits the full set, so autograd through this
    forward runs pinned planned backward kernels.  ``use_kernels=False`` is
    the plain PyTorch forward.
    """
    sched = schedules or {}
    x = images
    for i in range(cfg.n_layers):
        f, b = params[f"conv{i}"], params[f"bias{i}"]
        if use_kernels:
            x = conv_block(x, f, b, 1, F // 2, 2, "strip", sched.get(f"conv{i}"),
                           _bwd_for(sched, f"conv{i}"))
        else:
            x = conv2d_fused_ref(x, f, b, stride=1, padding=F // 2, relu=True,
                                 pool=2)
    x = x.reshape(x.shape[0], -1)
    if use_kernels:
        x = torch.relu(fc_layer(x, params["fc1"], sched.get("fc1"),
                                _bwd_for(sched, "fc1")) + params["fc1_b"])
        return fc_layer(x, params["fc2"], sched.get("fc2"),
                        _bwd_for(sched, "fc2")) + params["fc2_b"]
    x = torch.relu(_promoted_matmul(x, params["fc1"]) + params["fc1_b"])
    return _promoted_matmul(x, params["fc2"]) + params["fc2_b"]


def _promoted_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w at the promoted dtype, as JAX's ``@`` computes a bf16
    activation against f32 weights: the f32 product, unrounded."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return x.to(dt) @ w.to(dt)


def _stage_bytes(name: str, in_bytes: int, machine) -> int:
    """The element size a stage is planned at: ``in_bytes``, but fc2 on the
    H100 at its operands' 4 bytes on every route (fc1's f32 bias promotes
    its input): ``repro`` charges it at ``in_bytes``, which at 2 picks a
    fused dX/dW tile that one block's shared memory cannot hold at f32
    (ROADMAP queue 3)."""
    if name == "fc2" and (machine or H100).name == H100.name:
        return max(in_bytes, 4)
    return in_bytes


def plan_forward(cfg: ModelConfig, batch: int, *, in_bytes: int = 4,
                 machine=None, mesh=None, shard_axis: str = "data",
                 shard_strategy: str | None = None, conv_algorithm=None,
                 autotune=None) -> dict:
    """Plan every kernel launch of :func:`forward` without running it:
    {stage name: Schedule}.  With ``mesh=`` every stage comes back as a
    ShardedSchedule (the conv stages shard the batch or the output stack
    over ``shard_axis``, the FC stages pick their batch/psum/ring/tp
    dataflow by modeled words; ``shard_strategy`` pins one partition for
    every stage) — :func:`forward` consumes either flavor, a 1-device mesh
    reproducing the meshless plans exactly.  ``conv_algorithm`` pins one
    family of the conv stages' two-level argmin ("direct"/"im2col"); the
    default lets both compete per stage.  ``autotune=``
    ("cache-only"/"tune") resolves every stage through the measured-winner
    cache (repro_torch.plan.autotune) before the argmin."""
    from repro_torch.core import conv_layer as cl
    from repro_torch.core import fc_layer as fl

    out = {}
    for name, x_shape, w_shape in _stage_geometry(cfg, batch):
        if name.startswith("conv"):
            out[name] = cl.plan(x_shape, w_shape, stride=1, padding=F // 2,
                                pool=2, in_bytes=in_bytes, machine=machine, mesh=mesh,
                                shard_axis=shard_axis, shard_strategy=shard_strategy,
                                algorithm=conv_algorithm, autotune=autotune)
        else:
            out[name] = fl.plan(x_shape, w_shape,
                                in_bytes=_stage_bytes(name, in_bytes, machine),
                                machine=machine, mesh=mesh, shard_axis=shard_axis,
                                strategy=shard_strategy, autotune=autotune)
    return out


def plan_training(cfg: ModelConfig, batch: int, *, in_bytes: int = 4,
                  machine=None, mesh=None, shard_axis: str = "data",
                  shard_strategy: str | None = None, conv_algorithm=None,
                  autotune=None) -> dict:
    """:func:`plan_forward` plus every backward kernel autograd runs:
    "<stage>.dgrad"/"<stage>.wgrad" for conv stages (the fused-epilogue
    backward; a "<stage>.recompute" entry appears only on ragged
    geometries), "<stage>.dx"/"<stage>.dw" for FC stages.  Pass the result
    via ``schedules=`` so the whole training step runs pinned planned
    kernels.  With ``mesh=`` the wgrad/dw entries also charge the gradient
    all-reduce (Alg 4's tree reduction) as ``ici_words`` — the modeled cost
    of data-parallel training, split HBM vs interconnect.  The backward
    stages resolve through the same ``autotune=`` policy."""
    from repro_torch.core import conv_layer as cl
    from repro_torch.core import fc_layer as fl

    out = plan_forward(cfg, batch, in_bytes=in_bytes, machine=machine, mesh=mesh,
                       shard_axis=shard_axis, shard_strategy=shard_strategy,
                       conv_algorithm=conv_algorithm, autotune=autotune)
    for name, x_shape, w_shape in _stage_geometry(cfg, batch):
        if name.startswith("conv"):
            # pool=2 matches forward()'s fused conv_block epilogue.
            bwd = cl.plan_bwd(x_shape, w_shape, stride=1, padding=F // 2, pool=2,
                              in_bytes=in_bytes, machine=machine, mesh=mesh,
                              shard_axis=shard_axis, autotune=autotune)
        else:
            bwd = fl.plan_bwd(x_shape, w_shape,
                              in_bytes=_stage_bytes(name, in_bytes, machine),
                              machine=machine, mesh=mesh, shard_axis=shard_axis,
                              autotune=autotune)
        for k, s in bwd.items():
            out[f"{name}.{k}"] = s
    return out
