"""The train step: the family's loss, autograd through the planned
kernels, microbatch gradient accumulation, optional error-feedback int8
gradient compression, AdamW; and the chunked cross-entropy of the token
families.  (The elastic loop of the JAX package waits for a later slice.)
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.models.layers import ce_chunks
from repro_torch.models.registry import get_family
from repro_torch.optim import adamw
from repro_torch.optim.compression import compress_tree, init_error_buffers


@dataclasses.dataclass(frozen=True)
class TrainState:
    params: dict
    opt: adamw.AdamWState
    err: dict | None = None  # error-feedback buffers (compression) or None


def chunked_ce(cfg: ModelConfig, fam, params, hidden, labels, n_chunks: int,
               schedules: dict | None = None, head: torch.Tensor | None = None):
    """Cross-entropy without materializing [B, S, vocab]: a loop over token
    chunks; labels < 0 are masked.  ``schedules`` (a planned schedule set
    with a "logits" entry, e.g. ``transformer.plan_training``) routes each
    chunk's logits GEMM through the family's planned head, on ``head``
    (its [d, vocab] weight, made once per step) when given."""
    B, S, d = hidden.shape
    n = ce_chunks(S, n_chunks)
    hs = hidden.reshape(B, n, S // n, d).transpose(0, 1)
    ls = labels.reshape(B, n, S // n).transpose(0, 1)
    lkw = {"schedules": schedules, "head": head} if schedules else {}
    tot = cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for h, lab in zip(hs, ls):
        logits = fam.logits(cfg, params, h, **lkw).float()
        lse = torch.logsumexp(logits, -1)
        tgt = logits.gather(-1, lab.clamp(min=0).long()[..., None])[..., 0]
        mask = (lab >= 0).float()
        tot = tot + ((lse - tgt) * mask).sum()
        cnt = cnt + mask.sum()
    return tot / cnt.clamp(min=1.0)


def make_loss_fn(cfg: ModelConfig, tcfg: TrainConfig):
    """The family registry owns the loss: a family's ``make_loss_fn`` hook
    (the cnn's image cross-entropy, the dense transformer's planned chunked
    CE) builds it; every other token family (MoE, RWKV-6, Zamba2, the
    encoder-decoder) trains on the generic composition below, the
    family's plain forward (``frames`` passed on where the batch has them)
    and the chunked cross-entropy, as in the JAX package."""
    fam = get_family(cfg.family)
    hook = getattr(fam, "make_loss_fn", None)
    if hook is not None:
        return hook(cfg, tcfg)
    dt = getattr(torch, tcfg.compute_dtype)

    def loss_fn(params, batch):
        extra = {"frames": batch["frames"].to(dt)} if "frames" in batch else {}
        h, _ = fam.forward(cfg, params, batch["tokens"], remat=tcfg.remat,
                           compute_dtype=dt, **extra)
        return chunked_ce(cfg, fam, params, h, batch["labels"], tcfg.loss_chunks)

    return loss_fn


def batch_to(batch: dict, device) -> dict:
    """A data source's numpy batch as tensors on ``device``."""
    return {k: torch.from_numpy(np.asarray(v)).to(device) for k, v in batch.items()}


def is_accumulated(batch: dict) -> bool:
    """A batch with a leading accumulation dim (``[n_accum, micro, ...]``):
    tokens with 3 dims or images with 5, as the JAX package decides."""
    return (("tokens" in batch and batch["tokens"].ndim == 3)
            or ("images" in batch and batch["images"].ndim == 5))


def loss_and_grads(loss_fn, params: dict, batch: dict):
    """(loss, {name: f32 gradient}) of ``loss_fn`` at ``params``.  A batch
    with a leading accumulation dim runs one autograd pass per micro-batch,
    in order, summing the gradients in f32 from zeros; gradients and loss
    are then divided by the number of micro-batches."""
    names = list(params)

    def one(mb):
        leaves = [params[k].detach().requires_grad_(True) for k in names]
        loss = loss_fn(dict(zip(names, leaves)), mb)
        return loss.detach(), torch.autograd.grad(loss, leaves)

    if not is_accumulated(batch):
        loss, grads = one(batch)
        return loss, {k: g.float() for k, g in zip(names, grads)}
    n = next(iter(batch.values())).shape[0]
    gsum = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in params.items()}
    lsum = torch.zeros((), dtype=torch.float32, device=next(iter(params.values())).device)
    for i in range(n):
        loss, grads = one({k: v[i] for k, v in batch.items()})
        gsum = {k: gsum[k] + g.float() for k, g in zip(names, grads)}
        lsum = lsum + loss
    return lsum / n, {k: g / n for k, g in gsum.items()}


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig):
    """Returns train_step(state, batch) -> (state, metrics): the loss and
    its gradients with respect to every parameter (autograd; under
    ``tcfg.planned_kernels`` through the planned backward kernels; summed
    over the micro-batches of a batch with a leading accumulation dim),
    ``int8_ef`` compression of the gradients where ``tcfg`` asks for it,
    then one AdamW update.  ``batch`` holds tensors on the parameters'
    device."""
    loss_fn = make_loss_fn(cfg, tcfg)

    def train_step(state: TrainState, batch: dict):
        loss, grads = loss_and_grads(loss_fn, state.params, batch)
        err = state.err
        if tcfg.grad_compression == "int8_ef" and err is not None:
            grads, err = compress_tree(grads, err)
        params, opt, metrics = adamw.apply_updates(
            {k: p.detach() for k, p in state.params.items()}, grads, state.opt, tcfg)
        return TrainState(params, opt, err), dict(metrics, loss=loss)

    return train_step


def init_state(cfg: ModelConfig, tcfg: TrainConfig, params: dict) -> TrainState:
    del cfg
    err = init_error_buffers(params) if tcfg.grad_compression == "int8_ef" else None
    return TrainState(params=params, opt=adamw.init(params), err=err)
