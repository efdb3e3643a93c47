"""Sharding specs of a training state, as the JAX package's
``launch/specs.py`` builds them: FSDP/ZeRO specs of the parameters and the
moments, the parameter counts, and the default training config of a cell.

Everything here reads shapes only (``abstract_params`` tensors on the
``meta`` device, or anything with ``.shape``); no weight is allocated.
``Cell``, ``build_cell`` and the abstract batches of the dry run wait for
ROADMAP queue 1 #7.
"""

from __future__ import annotations

import math

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.models.module import count_params, flatten_defs
from repro_torch.plan.sharded import P


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
