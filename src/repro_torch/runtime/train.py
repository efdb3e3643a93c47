"""The train step: the family's loss, autograd through the planned
kernels, AdamW.  (Microbatch accumulation, gradient compression, chunked
cross-entropy and the elastic loop of the JAX package wait for later
slices.)
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.models.registry import get_family
from repro_torch.optim import adamw


@dataclasses.dataclass(frozen=True)
class TrainState:
    params: dict
    opt: adamw.AdamWState


def make_loss_fn(cfg: ModelConfig, tcfg: TrainConfig):
    """The family registry owns the loss (its ``make_loss_fn`` hook)."""
    return get_family(cfg.family).make_loss_fn(cfg, tcfg)


def batch_to(batch: dict, device) -> dict:
    """A data source's numpy batch as tensors on ``device``."""
    return {k: torch.from_numpy(np.asarray(v)).to(device) for k, v in batch.items()}


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig):
    """Returns train_step(state, batch) -> (state, metrics): the loss and
    its gradients with respect to every parameter (autograd; under
    ``tcfg.planned_kernels`` through the planned backward kernels), then
    one AdamW update.  ``batch`` holds tensors on the parameters' device."""
    loss_fn = make_loss_fn(cfg, tcfg)

    def train_step(state: TrainState, batch: dict):
        names = list(state.params)
        leaves = [state.params[k].detach().requires_grad_(True) for k in names]
        loss = loss_fn(dict(zip(names, leaves)), batch)
        grads = torch.autograd.grad(loss, leaves)
        grads = {k: g.float() for k, g in zip(names, grads)}
        params, opt, metrics = adamw.apply_updates(
            {k: p.detach() for k, p in zip(names, leaves)}, grads, state.opt, tcfg)
        return TrainState(params, opt), dict(metrics, loss=loss.detach())

    return train_step


def init_state(cfg: ModelConfig, tcfg: TrainConfig, params: dict) -> TrainState:
    del cfg, tcfg
    return TrainState(params=params, opt=adamw.init(params))
