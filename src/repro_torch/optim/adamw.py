"""AdamW over a ``{name: tensor}`` parameter dict, the JAX package's
update rule: f32 moments whatever the parameter dtype, global-norm
clipping, linear warmup then cosine decay to 10 %, decoupled weight decay
on matrices only.  The update is functional — it returns new tensors and
leaves its inputs alone, as the JAX version does.  On a mesh the
data-parallel step runs it alike on every rank over replicated moments
(``runtime.train``); ZeRO-1 sharding of the moments (``zero1``) waits for
ROADMAP queue 1 #5b.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.configs.base import TrainConfig


@dataclasses.dataclass(frozen=True)
class AdamWState:
    step: int
    m: dict
    v: dict


def init(params: dict) -> AdamWState:
    zeros = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for k, p in params.items()}
    return AdamWState(step=0, m=zeros, v={k: z.clone() for k, z in zeros.items()})


def lr_schedule(cfg: TrainConfig, step: int) -> float:
    """Linear warmup then cosine decay to 10%."""
    warm = min(step / max(cfg.warmup_steps, 1), 1.0)
    frac = (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1)
    frac = min(max(frac, 0.0), 1.0)
    cos = 0.1 + 0.45 * (1 + math.cos(math.pi * frac))
    return cfg.learning_rate * warm * cos


def global_norm(tree: dict) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in tree.values()))


def apply_updates(params: dict, grads: dict, state: AdamWState, cfg: TrainConfig):
    """Returns (new_params, new_state, metrics)."""
    gnorm = global_norm(grads)
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
