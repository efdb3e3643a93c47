"""Serving step builders: prefill (KV-cache fill + last-token logits) and
decode (one token against a long cache) — the JAX package's
``runtime/serve.py``.

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

On a mesh (``parallel=``, a ParallelCtx, as the JAX package's builders
take it) every rank gets the same global tokens and takes its shard of the
rows over the data axes (``ParallelCtx.batch_axes``); over a model axis
above 1 every token family runs tensor-parallel (the MoE's experts
expert-parallel or TP-within-expert; RWKV-6's and Mamba-2's heads).  The
cache a builder makes or takes is this rank's piece (the family's
``init_cache(parallel=)``): its rows; where the heads split, the KV heads
its query heads read (``layers.cache_heads``) — the placement
``parallel.kv_cache_spec`` gives, except that KV heads the model axis
cannot split stay whole on each rank where the spec would split the head
dim; and a recurrent state's heads (RWKV-6's ``wkv``, Mamba-2's ``ssd``,
the ``x`` channels of its ``conv`` with ``B``/``C`` whole; the token-shift
states whole), whatever ``cache_specs``' shape heuristic says of them.
Where the batch leaves data axes idle (batch 1 on a mesh: the
``long_500k`` decode), each KV leaf's sequence spreads over them as
``kv_cache_spec`` places it: a rank holds a contiguous run of ``Smax / n``
positions (the encoder-decoder's cross K/V a run of its frames), the rows
are replicated over those axes, and the attention merges the ranks'
pieces (``models/attention.py``); recurrent states stay whole there.  A
KV cache whose spec gives the sequence to the model axis raises (ROADMAP
queue 3).  The logits come back whole: gathered over the vocab shards and
the rows.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.registry import get_family
from repro_torch.runtime import parallel as par

# The cache leaves that are KV caches ([L, B, S, Hkv, Dh]; the
# encoder-decoder's cross K/V too); any other leaf is a recurrent state.
KV_LEAVES = ("k", "v", "xk", "xv")


def serving_param_specs(cfg: ModelConfig) -> dict:
    """The specs a serving rank places its weights by: the family's
    ``param_specs``, but with the model axis taken out of the leaves every
    model rank uses whole (the family's ``WHOLE_OVER_MODEL``: RWKV-6's
    channel-mix ``wr``, Mamba-2's ``w_in`` and conv; an embedding split
    over d_model, ``layers.embed_whole_over_model``).  Placed by
    ``param_specs``, such a leaf is gathered over the model axis at every
    step; the training step keeps the JAX package's layout and gathers it
    once a step."""
    from repro_torch.models.layers import MODEL_AXIS, embed_whole_over_model
    from repro_torch.models.module import param_specs
    from repro_torch.plan.sharded import P

    fam = get_family(cfg.family)
    specs = param_specs(fam.param_defs(cfg))
    whole = set(getattr(fam, "WHOLE_OVER_MODEL", ())) | set(embed_whole_over_model(specs))

    def drop(entry):
        rest = tuple(a for a in par.spec_axes(entry) if a != MODEL_AXIS)
        return rest if len(rest) > 1 else (rest[0] if rest else None)

    return {k: P(*(drop(e) for e in s)) if k in whole else s for k, s in specs.items()}


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


class _Mesh:
    """What a builder does on ``parallel``'s mesh (nothing without one):
    the forward's mesh keywords, this rank's rows of a global batch, its
    piece of a fresh cache, and the whole logits."""

    def __init__(self, cfg: ModelConfig, parallel):
        self.cfg, self.parallel = cfg, parallel
        self.tp_kw = {"parallel": parallel} if par.tp_size(parallel) > 1 else {}

    def kv_split(self, fam, batch: int):
        """The SeqSplit of a ``batch``-row KV cache: the data axes the
        batch leaves idle, where the family caches K/V (``None`` where no
        axis idles)."""
        ctx = self.parallel
        spare = () if ctx is None else ctx.spare_dp_axes(batch)
        if not spare or ctx.mesh.axis_size(spare) == 1:
            return None
        whole = fam.init_cache(self.cfg, 1, 1, torch.float32, device="meta")
        if not any(name in whole for name in KV_LEAVES):
            return None
        return par.SeqSplit(ctx.mesh, spare)

    def kw(self, fam, batch: int) -> dict:
        """The forward's mesh keywords for a ``batch``-row step."""
        split = self.kv_split(fam, batch)
        return {**self.tp_kw, **({"kv_split": split} if split is not None else {})}

    def _entry(self, batch: int):
        axes = self.parallel.batch_axes(batch)
        return axes if len(axes) > 1 else (axes[0] if axes else None)

    def rows(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a global ``x`` [B, ...]."""
        if self.parallel is None:
            return x
        spec = (self._entry(x.shape[0]),) + (None,) * (x.ndim - 1)
        return par.shard_tensor(x, spec, self.parallel.mesh)

    def init_cache(self, fam, batch: int, max_seq: int, dtype, device) -> dict:
        """A fresh cache of ``batch`` rows, this rank's piece of it."""
        cfg, ctx = self.cfg, self.parallel
        if ctx is None:
            return fam.init_cache(cfg, batch, max_seq, dtype, device=device)
        n = ctx.mesh.axis_size(par.spec_axes(self._entry(batch)))
        whole = fam.init_cache(cfg, batch, max_seq, dtype, device="meta")
        specs = par.cache_specs(ctx, whole)
        split = self.kv_split(fam, batch)
        for name in KV_LEAVES:
            if name not in whole:
                continue
            if ctx.tp_axis in par.spec_axes(specs[name][2]):
                raise NotImplementedError(
                    f"a KV cache of {batch} rows on mesh {dict(ctx.mesh.shape)} would "
                    f"split its sequence over the model axis ({specs[name]}), which the "
                    "port does not (ROADMAP queue 3 #22)")
            if split is not None and whole[name].shape[2] % split.n:
                raise NotImplementedError(
                    f"cache leaf {name!r} of {whole[name].shape[2]} positions does not "
                    f"split over the {split.n} ranks of the idle data axes {split.axes}, "
                    "where the JAX package keeps it whole (ROADMAP queue 3 #22)")
        if split is None:
            return fam.init_cache(cfg, batch // n, max_seq, dtype, device=device,
                                  **self.tp_kw)
        cache = fam.init_cache(cfg, batch // n, max_seq // split.n, dtype, device=device,
                               **self.tp_kw)
        for name in KV_LEAVES:
            if name in cache and cache[name].shape[2] != whole[name].shape[2] // split.n:
                shape = list(cache[name].shape)
                shape[2] = whole[name].shape[2] // split.n
                cache[name] = torch.zeros(shape, dtype=dtype, device=device)
        return cache

    def logits(self, fam, params, h, batch: int) -> torch.Tensor:
        """The logits of this rank's rows, put back whole: every vocab
        column and every row of the global batch."""
        out = fam.logits(self.cfg, params, h, **self.tp_kw)
        if self.parallel is None:
            return out
        from repro_torch.models.layers import vocab_split

        vocab = self.parallel.tp_axis if vocab_split(self.cfg, self.parallel) else None
        spec = (self._entry(batch),) + (None,) * (out.ndim - 2) + (vocab,)
        return par.gather_tensor(out, spec, self.parallel.mesh)


def make_prefill_step(cfg: ModelConfig, max_seq: int, compute_dtype="bfloat16",
                      cache_dtype="bfloat16", parallel=None):
    """prefill(params, {"tokens": [B, S]}) -> (cache, logits [B, 1, vocab]);
    the encoder-decoder also takes ``"frames"`` [B, T_enc, d]."""
    fam = get_family(cfg.family)
    dt, cdt = torch_dtype(compute_dtype), torch_dtype(cache_dtype)
    mesh = _Mesh(cfg, parallel)

    @torch.no_grad()
    def prefill(params, batch):
        tokens = _on(params, batch["tokens"])
        B = tokens.shape[0]
        cache = mesh.init_cache(fam, B, max_seq, cdt, tokens.device)
        extra = ({"frames": mesh.rows(_on(params, batch["frames"]).to(dt))}
                 if "frames" in batch else {})
        h, cache = fam.forward(cfg, params, mesh.rows(tokens), pos0=0, cache=cache,
                               compute_dtype=dt, **extra, **mesh.kw(fam, B))
        return cache, mesh.logits(fam, params, h[:, -1:, :], B)

    return prefill


def make_decode_step(cfg: ModelConfig, compute_dtype="bfloat16", parallel=None):
    """decode(params, cache, tokens [B, 1], pos scalar) -> (cache, logits)."""
    fam = get_family(cfg.family)
    dt = torch_dtype(compute_dtype)
    mesh = _Mesh(cfg, parallel)

    @torch.no_grad()
    def decode(params, cache, tokens, pos):
        tokens = _on(params, tokens)
        h, cache = fam.forward(cfg, params, mesh.rows(tokens), pos0=pos, cache=cache,
                               compute_dtype=dt, **mesh.kw(fam, tokens.shape[0]))
        return cache, mesh.logits(fam, params, h, tokens.shape[0])

    return decode


def make_bucket_prefill_step(cfg: ModelConfig, max_seq: int, compute_dtype="float32",
                             cache_dtype="float32", parallel=None, schedules=None,
                             machine=None):
    """``prefill(params, tokens [B, S_bucket], lengths [B]) ->
    (cache, logits [B, vocab])`` for ragged prompts padded to a bucket.

    The hidden state is gathered at each row's true last position
    (``lengths - 1``), not at the padded ``S_bucket - 1`` — with causal
    masking that makes the returned logits independent of the padding.
    The cache is allocated at the full ``max_seq`` extent so the engine
    can scatter rows straight into its slot pool."""
    fam = get_family(cfg.family)
    dt, cdt = torch_dtype(compute_dtype), torch_dtype(cache_dtype)
    mesh = _Mesh(cfg, parallel)
    _check_schedules(schedules, machine)

    @torch.no_grad()
    def prefill(params, tokens, lengths):
        tokens, lengths = _on(params, tokens), _on(params, lengths)
        B, S = tokens.shape
        cache = mesh.init_cache(fam, B, max_seq, cdt, tokens.device)
        tokens, lengths = mesh.rows(tokens), mesh.rows(lengths)
        h, cache = fam.forward(cfg, params, tokens, pos0=0, cache=cache, compute_dtype=dt,
                               **mesh.kw(fam, B))
        last = (lengths.long() - 1).clamp(0, S - 1)
        h_last = h[torch.arange(h.shape[0], device=h.device), last]  # [B_loc, d]
        return cache, mesh.logits(fam, params, h_last[:, None, :], B)[:, 0]

    return prefill


def make_slot_decode_step(cfg: ModelConfig, compute_dtype="float32", parallel=None,
                          schedules=None, machine=None):
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
    mesh = _Mesh(cfg, parallel)
    _check_schedules(schedules, machine)

    @torch.no_grad()
    def decode(params, cache, tokens, pos):
        tokens = _on(params, tokens).to(torch.int32)
        B = tokens.shape[0]
        pos = mesh.rows(_on(params, pos).to(torch.int32))
        h, cache = fam.forward(cfg, params, mesh.rows(tokens)[:, None], pos0=pos, cache=cache,
                               compute_dtype=dt, **per_slot, **mesh.kw(fam, B))
        return cache, mesh.logits(fam, params, h, B)[:, 0]

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
