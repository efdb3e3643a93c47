"""Serving step builders: prefill (KV-cache fill + last-token logits) and
decode (one token against a long cache) — the JAX package's
``runtime/serve.py`` on one device.

Two tiers:

  * ``make_prefill_step`` / ``make_decode_step`` — the simple whole-batch
    builders (shared scalar decode position) used by tests and
    ``greedy_generate``.
  * ``make_bucket_prefill_step`` / ``make_slot_decode_step`` — the
    continuous-batching builders ``repro_torch.serve.Engine`` builds once
    per warmup bucket: ragged prompts padded to the bucket shape with the
    last-token logits gathered at each row's true length, and per-slot
    decode positions (one batched forward whose positions, RoPE, cache
    writes and masks are per row) so every KV slot advances independently.
    Both accept the bucket's warmup-resolved ``schedules``
    (``BucketLadder.plans[bucket]``) and fail fast when a planned cell does
    not fit the machine — request-time dispatch never re-plans.

Every builder returns a plain function that runs under ``torch.no_grad()``
on the device its params live on; there is nothing to compile.  The
forward is the family's plain PyTorch path with a cache, as the JAX
package's serving runs its XLA forward and no Pallas kernel: the kernels
run at boot only, when ``BucketLadder.warmup`` tunes the bucket cells.

Caches are written in place (``models.transformer.forward``): the prefill
builders allocate a fresh cache per call, and a decode step returns the
cache it was given, updated.

Bit-identity contract (as in the JAX package): the bucketed builders give
the greedy tokens of the unbucketed path — causal masking gives padded
positions exactly zero softmax weight (the -1e30 mask underflows), rows of
every matmul are independent, and decode overwrites cache positions >= the
true prompt length as it generates.  (On the card, GEMMs of another shape
may round differently, so two paths can part at a near-tie.)
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.registry import get_family


def _check_schedules(schedules, machine) -> None:
    """Warmup-resolved cells must fit the serving machine — a plan that
    does not fit should fail at boot, not at request time."""
    if not schedules or machine is None:
        return
    for name, sched in schedules.items():
        fits = getattr(sched, "fits", None)
        if fits is not None and not fits(machine):
            raise ValueError(
                f"serving cell {name!r} does not fit {machine.name}: "
                f"{sched}")


def torch_dtype(dtype) -> torch.dtype:
    """``torch.float32`` for ``torch.float32``, ``"float32"`` or
    ``np.float32``."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return getattr(torch, dtype if isinstance(dtype, str) else np.dtype(dtype).name)


def params_device(params: dict) -> torch.device:
    return next(iter(params.values())).device


def _on(params: dict, x) -> torch.Tensor:
    """``x`` (a tensor or an array) on the params' device."""
    return torch.as_tensor(x, device=params_device(params))


def make_prefill_step(cfg: ModelConfig, max_seq: int, compute_dtype="bfloat16",
                      cache_dtype="bfloat16"):
    """prefill(params, {"tokens": [B, S]}) -> (cache, logits [B, 1, vocab]);
    the encoder-decoder also takes ``"frames"`` [B, T_enc, d]."""
    fam = get_family(cfg.family)
    dt, cdt = torch_dtype(compute_dtype), torch_dtype(cache_dtype)

    @torch.no_grad()
    def prefill(params, batch):
        tokens = _on(params, batch["tokens"])
        cache = fam.init_cache(cfg, tokens.shape[0], max_seq, cdt, device=tokens.device)
        extra = {"frames": _on(params, batch["frames"]).to(dt)} if "frames" in batch else {}
        h, cache = fam.forward(cfg, params, tokens, pos0=0, cache=cache, compute_dtype=dt,
                               **extra)
        return cache, fam.logits(cfg, params, h[:, -1:, :])

    return prefill


def make_decode_step(cfg: ModelConfig, compute_dtype="bfloat16"):
    """decode(params, cache, tokens [B, 1], pos scalar) -> (cache, logits)."""
    fam = get_family(cfg.family)
    dt = torch_dtype(compute_dtype)

    @torch.no_grad()
    def decode(params, cache, tokens, pos):
        h, cache = fam.forward(cfg, params, _on(params, tokens), pos0=pos, cache=cache,
                               compute_dtype=dt)
        return cache, fam.logits(cfg, params, h)

    return decode


def make_bucket_prefill_step(cfg: ModelConfig, max_seq: int, compute_dtype="float32",
                             cache_dtype="float32", schedules=None, machine=None):
    """``prefill(params, tokens [B, S_bucket], lengths [B]) ->
    (cache, logits [B, vocab])`` for ragged prompts padded to a bucket.

    The hidden state is gathered at each row's true last position
    (``lengths - 1``), not at the padded ``S_bucket - 1`` — with causal
    masking that makes the returned logits independent of the padding.
    The cache is allocated at the full ``max_seq`` extent so the engine
    can scatter rows straight into its slot pool."""
    fam = get_family(cfg.family)
    dt, cdt = torch_dtype(compute_dtype), torch_dtype(cache_dtype)
    _check_schedules(schedules, machine)

    @torch.no_grad()
    def prefill(params, tokens, lengths):
        tokens, lengths = _on(params, tokens), _on(params, lengths)
        B, S = tokens.shape
        cache = fam.init_cache(cfg, B, max_seq, cdt, device=tokens.device)
        h, cache = fam.forward(cfg, params, tokens, pos0=0, cache=cache, compute_dtype=dt)
        last = (lengths.long() - 1).clamp(0, S - 1)
        h_last = h[torch.arange(B, device=h.device), last]  # [B, d]
        return cache, fam.logits(cfg, params, h_last[:, None, :])[:, 0]

    return prefill


def make_slot_decode_step(cfg: ModelConfig, compute_dtype="float32", schedules=None,
                          machine=None):
    """``decode(params, cache, tokens [B], pos [B]) ->
    (cache, logits [B, vocab])`` with a *per-slot* position.

    The simple ``make_decode_step`` advances every row at one shared
    scalar position — useless for continuous batching, where each slot is
    mid-way through its own sequence.  Here one batched forward takes a
    position per row (axis 1 of every cache leaf is the slot axis, see
    ``models.registry.init_cache_slots``): each slot ropes at, writes its
    cache row at and masks from its own position — what the JAX package
    gets by ``vmap``-ing a batch-1 forward over the slots.  Where rows of
    one forward are coupled (the MoE's expert capacity), the family's
    ``slot_decode_kwargs`` hook names the forward's keywords that cut the
    coupling, so each slot computes what a batch-1 call would."""
    fam = get_family(cfg.family)
    dt = torch_dtype(compute_dtype)
    per_slot = getattr(fam, "slot_decode_kwargs", {})
    _check_schedules(schedules, machine)

    @torch.no_grad()
    def decode(params, cache, tokens, pos):
        tokens = _on(params, tokens).to(torch.int32)[:, None]
        pos = _on(params, pos).to(torch.int32)
        h, cache = fam.forward(cfg, params, tokens, pos0=pos, cache=cache, compute_dtype=dt,
                               **per_slot)
        return cache, fam.logits(cfg, params, h)[:, 0]

    return decode


def greedy_generate(cfg: ModelConfig, params, prompt, steps: int, max_seq: int,
                    compute_dtype="float32") -> torch.Tensor:
    """Reference loop for tests: prefill then greedy decode; tokens
    [B, steps] int32 on the params' device."""
    prefill = make_prefill_step(cfg, max_seq, compute_dtype, compute_dtype)
    decode = make_decode_step(cfg, compute_dtype)
    prompt = _on(params, prompt)
    cache, logits = prefill(params, {"tokens": prompt})
    toks = [torch.argmax(logits[:, -1], -1)]
    pos = prompt.shape[1]
    for _ in range(steps - 1):
        cache, logits = decode(params, cache, toks[-1][:, None], pos)
        toks.append(torch.argmax(logits[:, -1], -1))
        pos += 1
    return torch.stack(toks, 1).to(torch.int32)
