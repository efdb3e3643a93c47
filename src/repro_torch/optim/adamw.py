"""AdamW over a ``{name: tensor}`` parameter dict, the JAX package's
update rule: f32 moments whatever the parameter dtype, global-norm
clipping, linear warmup then cosine decay to 10 %, decoupled weight decay
on matrices only.  The update is functional — it returns new tensors and
leaves its inputs alone, as the JAX version does.  On a mesh it runs on
each rank's shards of the parameters and moments (``runtime.train``'s FSDP
step), the global-norm clip over the whole tree (one psum of the shards'
squared norms); ``zero1_specs`` gives the JAX package's ZeRO-1 specs of
the moments.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.plan.sharded import P


@dataclasses.dataclass(frozen=True)
class AdamWState:
    step: int
    m: dict
    v: dict


def init(params: dict) -> AdamWState:
    zeros = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for k, p in params.items()}
    return AdamWState(step=0, m=zeros, v={k: z.clone() for k, z in zeros.items()})


def abstract_state(params: dict) -> AdamWState:
    """The moments' shapes (f32) on the ``meta`` device; nothing is
    allocated."""
    z = {k: torch.empty(p.shape, dtype=torch.float32, device="meta")
         for k, p in params.items()}
    return AdamWState(step=0, m=z, v=dict(z))


def lr_schedule(cfg: TrainConfig, step: int) -> float:
    """Linear warmup then cosine decay to 10%."""
    warm = min(step / max(cfg.warmup_steps, 1), 1.0)
    frac = (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1)
    frac = min(max(frac, 0.0), 1.0)
    cos = 0.1 + 0.45 * (1 + math.cos(math.pi * frac))
    return cfg.learning_rate * warm * cos


def global_norm(tree: dict) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in tree.values()))


def sharded_global_norm(tree: dict, specs: dict, mesh) -> torch.Tensor:
    """The global norm of a tree whose leaves are this rank's shards under
    ``specs``: each shard's squared norm over the number of ranks holding
    the same shard, summed, and one psum over every mesh axis."""
    from repro_torch.runtime import collectives as coll
    from repro_torch.runtime.parallel import replication

    local = sum(torch.sum(torch.square(g.float())) / replication(specs[k], mesh)
                for k, g in tree.items())
    return torch.sqrt(coll.psum(local.reshape(1), mesh, mesh.axis_names)[0])


def apply_updates(params: dict, grads: dict, state: AdamWState, cfg: TrainConfig, *,
                  specs: dict | None = None, mesh=None):
    """Returns (new_params, new_state, metrics).  With ``specs`` and
    ``mesh`` the trees are this rank's shards under ``specs``, and the
    clip takes the whole tree's norm (:func:`sharded_global_norm`)."""
    gnorm = global_norm(grads) if specs is None else sharded_global_norm(grads, specs, mesh)
    clip = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0) if cfg.grad_clip else 1.0
    step = state.step + 1
    lr = lr_schedule(cfg, step)
    b1, b2 = cfg.beta1, cfg.beta2
    bc1, bc2 = 1 - b1 ** step, 1 - b2 ** step
    new_p, new_m, new_v = {}, {}, {}
    for k, p in params.items():
        g = grads[k].float() * clip
        m = b1 * state.m[k] + (1 - b1) * g
        v = b2 * state.v[k] + (1 - b2) * g * g
        u = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        if p.ndim >= 2:  # decoupled weight decay on matrices only
            u = u + cfg.weight_decay * p.float()
        new_p[k] = (p.float() - lr * u).to(p.dtype)
        new_m[k], new_v[k] = m, v
    return new_p, AdamWState(step, new_m, new_v), {"lr": lr, "grad_norm": gnorm}


def zero1_specs(param_specs: dict, params_abstract: dict, dp_axes: tuple,
                mesh_shape: dict) -> AdamWState:
    """ZeRO-1: shard each moment over the data axes on the first dimension
    that is unsharded and divisible by the data-parallel extent."""
    dp = 1
    for a in dp_axes:
        dp *= mesh_shape[a]

    def one(spec, shape):
        entries = list(spec) + [None] * (len(shape) - len(spec))
        for i, (e, n) in enumerate(zip(entries, shape)):
            if e is None and n % dp == 0 and n > 0:
                entries[i] = dp_axes if len(dp_axes) > 1 else dp_axes[0]
                return P(*entries)
        return P(*entries)

    moments = {k: one(s, tuple(params_abstract[k].shape)) for k, s in param_specs.items()}
    return AdamWState(step=P(), m=moments, v=dict(moments))
