"""The train step: the family's loss, autograd through the planned
kernels, microbatch gradient accumulation, optional error-feedback int8
gradient compression, AdamW; and the chunked cross-entropy of the token
families.  On a mesh (``parallel=``) each rank runs the step on its shard
of the batch over the data axes, in one of two ways:

* replicated (no ``grad_specs``, the cnn): every rank holds all the
  parameters and moments, the gradients are averaged with one psum over
  the data axes (Alg 4's private-output reduction at the scale of ranks),
  and AdamW runs alike on every rank;
* FSDP (``grad_specs``, the token families, as the JAX package's launcher
  shards them): each rank holds its shard of the parameters and of AdamW's
  moments under the specs; the step gathers each parameter over the data
  axes only, runs the loss (every token family tensor-parallel over the
  model axis), reduce-scatters the gradients back to the specs and runs
  AdamW on the shards; ``int8_ef`` compresses each rank's shards with the
  whole tensor's scale (:func:`~repro_torch.optim.compression.compress_sharded_tree`).

Both are the same function of the global batch as one device.
``run_elastic`` drives the steps through failures, the JAX package's
recovery state machine run once in each rank.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.models.layers import at_least_f32, ce_chunks
from repro_torch.models import registry
from repro_torch.models.registry import get_family
from repro_torch.optim import adamw
from repro_torch.optim.compression import (
    compress_sharded_tree, compress_tree, init_error_buffers,
)
from repro_torch.runtime import collectives as coll
from repro_torch.runtime import parallel as par


@dataclasses.dataclass(frozen=True)
class TrainState:
    params: dict
    opt: adamw.AdamWState
    err: dict | None = None  # error-feedback buffers (compression) or None


def chunked_ce(cfg: ModelConfig, fam, params, hidden, labels, n_chunks: int,
               schedules: dict | None = None, head: torch.Tensor | None = None,
               parallel=None):
    """Cross-entropy without materializing [B, S, vocab]: a loop over token
    chunks; labels < 0 are masked.  ``schedules`` (a planned schedule set
    with a "logits" entry, e.g. ``transformer.plan_training``) routes each
    chunk's logits GEMM through the family's planned head, on ``head``
    (its [d, vocab] weight, made once per step) when given.  Under a vocab
    split over ``parallel``'s model axis (``layers.vocab_split``) each rank
    computes its vocab columns of the logits: a pmax and two psums over the
    model axis give the log-sum-exp and the target logit; the plain head is
    put in its rank-local layout once (``layers.head_of``: an embedding
    stored split over d_model is gathered whole, then split by vocab), not
    once a chunk."""
    from repro_torch.models.layers import head_of, vocab_split

    B, S, d = hidden.shape
    n = ce_chunks(S, n_chunks)
    hs = hidden.reshape(B, n, S // n, d).transpose(0, 1)
    ls = labels.reshape(B, n, S // n).transpose(0, 1)
    lkw = {"schedules": schedules, "head": head} if schedules else {}
    split = vocab_split(cfg, parallel)
    if par.tp_size(parallel) > 1:
        lkw["parallel"] = parallel
        if split and not schedules:
            name = "embed" if cfg.tie_embeddings else "w_out"
            params = dict(params, **{name: head_of(params, cfg, parallel)})
    tot = cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for h, lab in zip(hs, ls):
        logits = at_least_f32(fam.logits(cfg, params, h, **lkw))
        if split:
            lse, tgt = _vocab_parallel_terms(logits, lab, parallel)
        else:
            lse = torch.logsumexp(logits, -1)
            tgt = logits.gather(-1, lab.clamp(min=0).long()[..., None])[..., 0]
        mask = (lab >= 0).float()
        tot = tot + ((lse - tgt) * mask).sum()
        cnt = cnt + mask.sum()
    return tot / cnt.clamp(min=1.0)


def _vocab_parallel_terms(logits, labels, parallel):
    """(log-sum-exp, target logit) of rows whose vocab columns lie split
    over the model axis, this rank holding ``logits`` [..., V / tp]."""
    mesh, axis = parallel.mesh, parallel.tp_axis
    rows = logits.shape[-1]
    top = coll.pmax(logits.detach().amax(-1), mesh, axis)
    lse = torch.log(coll.psum(torch.exp(logits - top[..., None]).sum(-1), mesh, axis)) + top
    local = labels.long() - par.tp_rank(parallel) * rows
    mine = (local >= 0) & (local < rows)
    got = logits.gather(-1, local.clamp(0, rows - 1)[..., None])[..., 0]
    tgt = coll.psum(torch.where(mine, got, torch.zeros_like(got)), mesh, axis)
    return lse, tgt


def make_loss_fn(cfg: ModelConfig, tcfg: TrainConfig, parallel=None):
    """The family registry owns the loss: a family's ``make_loss_fn`` hook
    (the cnn's image cross-entropy, the dense transformer's planned chunked
    CE) builds it; every other token family (MoE, RWKV-6, Zamba2, the
    encoder-decoder) trains on the generic composition below, the
    family's plain forward (``frames`` passed on where the batch has them)
    and the chunked cross-entropy, as in the JAX package.  ``parallel``
    reaches a family's hook (the cnn, the dense transformer); the generic
    loss runs on this rank's data shard (each data rank's MoE dispatches
    its own tokens, as the JAX package's ``shard_map`` does) and, over a
    model axis above 1, passes ``parallel`` to the forward and the
    vocab-parallel cross-entropy."""
    fam = get_family(cfg.family)
    hook = getattr(fam, "make_loss_fn", None)
    if hook is not None:
        return hook(cfg, tcfg) if parallel is None else hook(cfg, tcfg, parallel)
    dt = getattr(torch, tcfg.compute_dtype)
    mesh_kw = {"parallel": parallel} if par.tp_size(parallel) > 1 else {}

    def loss_fn(params, batch):
        extra = {"frames": batch["frames"].to(dt)} if "frames" in batch else {}
        h, _ = fam.forward(cfg, params, batch["tokens"], remat=tcfg.remat,
                           compute_dtype=dt, **extra, **mesh_kw)
        return chunked_ce(cfg, fam, params, h, batch["labels"], tcfg.loss_chunks,
                          **mesh_kw)

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
    """(loss, {name: f32 gradient}) of ``loss_fn`` at ``params`` (f64
    gradients of f64 params).  A batch with a leading accumulation dim runs
    one autograd pass per micro-batch, in order, summing the gradients in
    f32 (f64) from zeros; gradients and loss
    are then divided by the number of micro-batches."""
    names = list(params)

    def one(mb):
        leaves = [params[k].detach().requires_grad_(True) for k in names]
        loss = loss_fn(dict(zip(names, leaves)), mb)
        return loss.detach(), torch.autograd.grad(loss, leaves)

    if not is_accumulated(batch):
        loss, grads = one(batch)
        return loss, {k: at_least_f32(g) for k, g in zip(names, grads)}
    n = next(iter(batch.values())).shape[0]
    gsum = {k: torch.zeros(p.shape, dtype=torch.promote_types(p.dtype, torch.float32),
                           device=p.device)
            for k, p in params.items()}
    lsum = torch.zeros((), dtype=torch.float32, device=next(iter(params.values())).device)
    for i in range(n):
        loss, grads = one({k: v[i] for k, v in batch.items()})
        gsum = {k: gsum[k] + at_least_f32(g) for k, g in zip(names, grads)}
        lsum = lsum + loss
    return lsum / n, {k: g / n for k, g in gsum.items()}


def batch_axes(parallel, batch: dict) -> tuple[str, ...]:
    """The dp axes a global batch shards over: the largest prefix of the
    data axes (outermost first) whose extent divides the batch; the dp
    axes past it hold replicas of the same shard."""
    lead = next(iter(batch.values()))
    rows = lead.shape[1] if is_accumulated(batch) else lead.shape[0]
    return parallel.batch_axes(rows)


def shard_batch(cfg: ModelConfig, parallel, batch: dict) -> dict:
    """This rank's shard of a global batch over the data axes (a PxDxM
    mesh: over (pod, data) at once), by the family's ``batch_shard_specs``
    (a batch with a leading accumulation dim shards its micro-batch dim)."""
    axes = batch_axes(parallel, batch)
    entry = axes if len(axes) > 1 else (axes[0] if axes else None)
    specs = registry.batch_shard_specs(cfg, entry)
    lead = (None,) if is_accumulated(batch) else ()
    return {k: par.shard_tensor(v, (*lead, *specs[k]), parallel.mesh)
            for k, v in batch.items()}


def all_reduce_mean(parallel, loss, grads: dict):
    """The mean over the data axes' ranks of the loss and every gradient,
    in one psum of one flat f32 buffer (the plan's wgrad/dW ``ici_words``;
    replicas along the model axis hold the same values and take no part)."""
    names = list(grads)
    flat = torch.cat([loss.reshape(1).float()] + [grads[k].reshape(-1) for k in names])
    flat = coll.psum(flat, parallel.mesh, parallel.dp_axes) / parallel.dp_size
    out, i = {}, 1
    for k in names:
        out[k] = flat[i:i + grads[k].numel()].view_as(grads[k])
        i += grads[k].numel()
    return flat[0], out


def fsdp_loss_and_grads(loss_fn, parallel, grad_specs: dict, shards: dict, batch: dict):
    """(loss, gradients of the shards) of the FSDP step: the loss of the
    parameters gathered over the data axes (each rank runs ``loss_fn`` on
    its ``batch`` shard), the gradients reduce-scattered back to
    ``grad_specs`` by the gather's backward — a shard whose spec names no
    data axis is summed over them by one psum — and both averaged over the
    data axes' ranks."""
    mesh, dp = parallel.mesh, parallel.dp_axes

    def sharded_loss(leaves, b):
        full = {k: par.gather_tensor(v, grad_specs[k], mesh, dp, grad=True)
                for k, v in leaves.items()}
        return loss_fn(full, b)

    loss, grads = loss_and_grads(sharded_loss, shards, batch)
    whole = [k for k in grads
             if not any(a in dp for e in grad_specs[k] for a in par.spec_axes(e))]
    flat = torch.cat([loss.reshape(1)] + [grads[k].reshape(-1) for k in whole])
    flat = coll.psum(flat, mesh, dp)
    n = parallel.dp_size
    out, i = {}, 1
    for k in whole:
        out[k] = flat[i:i + grads[k].numel()].view_as(grads[k]) / n
        i += grads[k].numel()
    for k, g in grads.items():
        if k not in out:
            out[k] = g / n
    return flat[0] / n, {k: out[k] for k in grads}


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig, parallel=None,
                    grad_specs: dict | None = None):
    """Returns train_step(state, batch) -> (state, metrics): the loss and
    its gradients with respect to every parameter (autograd; under
    ``tcfg.planned_kernels`` through the planned backward kernels; summed
    over the micro-batches of a batch with a leading accumulation dim),
    ``int8_ef`` compression of the gradients where ``tcfg`` asks for it,
    then one AdamW update.  ``batch`` holds tensors on the parameters'
    device.

    With ``parallel`` (a ``runtime.parallel.ParallelCtx`` on a live mesh)
    every rank passes the same global batch and the step takes this rank's
    shard of it.  Without ``grad_specs`` every rank holds the same
    parameters: the step averages loss and gradients over the data axes
    with one psum, then compresses and updates exactly as on one device.
    With ``grad_specs`` (``{name: P}``, the JAX package's ``fsdp_specs``)
    the state's parameters and moments are this rank's shards under them:
    the FSDP step (:func:`fsdp_loss_and_grads`), then AdamW on the shards
    with the whole tree's clip, ``int8_ef`` compressing each shard at its
    whole tensor's scale.  Either way the same function of the global
    batch.  Over a model axis above 1 the token families run
    tensor-parallel and the cnn replicates its step."""
    loss_fn = make_loss_fn(cfg, tcfg, parallel)

    def train_step(state: TrainState, batch: dict):
        upd = {}
        if parallel is None:
            loss, grads = loss_and_grads(loss_fn, state.params, batch)
        elif grad_specs is None:
            loss, grads = loss_and_grads(loss_fn, state.params,
                                         shard_batch(cfg, parallel, batch))
            loss, grads = all_reduce_mean(parallel, loss, grads)
        else:
            loss, grads = fsdp_loss_and_grads(loss_fn, parallel, grad_specs, state.params,
                                              shard_batch(cfg, parallel, batch))
            upd = dict(specs=grad_specs, mesh=parallel.mesh)
        err = state.err
        if tcfg.grad_compression == "int8_ef" and err is not None:
            grads, err = (compress_tree(grads, err) if grad_specs is None
                          else compress_sharded_tree(grads, err, grad_specs, parallel.mesh))
        params, opt, metrics = adamw.apply_updates(
            {k: p.detach() for k, p in state.params.items()}, grads, state.opt, tcfg, **upd)
        return TrainState(params, opt, err), dict(metrics, loss=loss)

    return train_step


def init_state(cfg: ModelConfig, tcfg: TrainConfig, params: dict) -> TrainState:
    del cfg
    err = init_error_buffers(params) if tcfg.grad_compression == "int8_ef" else None
    return TrainState(params=params, opt=adamw.init(params), err=err)


# ---------------------------------------------------------------------------
# The elastic fault-tolerant loop (DESIGN.md Sec. 7)
#
# A host WILL die mid-run, and since partitioning is a planner output,
# surviving is a plan-layer operation: a shrunk mesh is a new MeshSpec, so
# every ShardedSchedule is re-planned before the checkpoint restores.
# run_elastic() owns the generic state machine, the JAX package's step for
# step; the launcher owns build() (process group, mesh, step_fn, plans and
# restore for a device count).  Each rank runs the loop: every decision a
# rank takes alone (a stale heartbeat read at its own instant, its own
# step time) is first agreed across the ranks (``ElasticRun.agree``), so
# that no rank leaves a collective the others wait in.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RecoveryPolicy:
    """Bounds on the recovery state machine: how many re-meshes before
    giving up, how long to back off between them (doubled per retry), how
    many consecutive non-finite losses are skipped before rolling back
    to the last committed checkpoint, and how many consecutive straggler
    watchdog trips escalate to a :class:`HostFailure` eviction
    (``straggler_patience=0``, the default, keeps the report-only
    behavior: trips are logged but never acted on)."""

    max_recoveries: int = 3
    backoff_seconds: float = 0.0
    nonfinite_patience: int = 3
    straggler_patience: int = 0


@dataclasses.dataclass
class ElasticRun:
    """Everything run_elastic needs for one incarnation of the run — the
    launcher's ``build(n_devices)`` returns a fresh one after every
    re-mesh (new group and mesh, re-planned step_fn, restored state).

    The JAX package's fields, less ``mesh`` (the port's ops take their
    mesh explicitly), plus what a loop run once in each rank needs:
    ``agree`` and ``on_failure`` (both ``None`` on one process, where the
    loop is the JAX package's), and ``info``, the build's own record."""

    step_fn: Callable  # (state, batch) -> (state, metrics); leaves state as it was
    state: Any
    start: int  # first step this incarnation executes
    n_devices: int = 1
    # save(step, state): commit a checkpoint.  May return an async handle
    # (anything with .join(), e.g. checkpoint.AsyncSave) — run_elastic then
    # overlaps the write with training and joins it before the *next*
    # commit, at recovery, and at the end, surfacing writer failures at
    # the join point.  A None return means the save was synchronous.
    save: Callable | None = None
    ckpt_dir: str | None = None
    ckpt_every: int = 0
    devices_per_host: int = 1  # devices lost per dead host (TP extent)
    heartbeat: Any = None  # fault_tolerance.Heartbeat
    monitor: Any = None  # fault_tolerance.Monitor
    watchdog: Any = None  # fault_tolerance.StragglerWatchdog
    log_every: int = 10
    # agree(stale, survivors, trips) -> (stale, survivors, trips): this
    # rank's verdict of a step (the stale hosts it read and the devices it
    # counts alive; the hosts whose watchdog tripped) combined with every
    # rank's, the same on all of them (:func:`agree_verdict`).
    agree: Callable | None = None
    # on_failure(step, HostFailure): told as soon as a host failure is
    # raised, before the recovery joins the pending write and rebuilds.
    on_failure: Callable | None = None
    device: Any = "cpu"  # where the batch goes (batch_to)
    info: dict = dataclasses.field(default_factory=dict)


def agree_verdict(stale: list, survivors: int, trips: list):
    """Every rank's verdict of one step, combined alike on every rank by
    one small exchange over the process group: the stale hosts any rank
    read, the most live devices a rank that read them counts (a heartbeat
    one rank read live is proof of life; another rank may have read the
    directory before that host's first beat), and every host whose
    watchdog tripped, each sorted."""
    import torch.distributed as dist

    views = [None] * dist.get_world_size()
    dist.all_gather_object(views, (sorted(stale), int(survivors), sorted(trips)))
    stale_all = sorted({h for v in views for h in v[0]})
    counts = [v[1] for v in views if v[0]]
    trips_all = sorted({h for v in views for h in v[2]})
    return stale_all, (max(counts) if counts else 0), trips_all


def run_elastic(build: Callable, source: Callable, steps: int, *,
                policy: RecoveryPolicy | None = None, chaos=None,
                log: Callable = print):
    """Drive training to ``steps`` through failures.

    ``build(n_devices | None)`` -> :class:`ElasticRun`; ``None`` means the
    initial (full) device set.  Per step: heartbeat, monitor poll,
    straggler watchdog; a detected host failure (stale heartbeats, or
    injected via ``chaos``) aborts the step and recovers — shrink to the
    survivors, ``build`` re-meshes + re-plans + restores the last
    committed checkpoint — with bounded retries/backoff.  A non-finite
    loss skips the update (the poisoned state is never committed) and
    after ``nonfinite_patience`` consecutive bad steps rolls back to the
    last good checkpoint.  Returns ``(final_state, history)`` where
    history is one record per *executed* step.

    The JAX package's loop, step for step, with three differences: the
    batch goes through :func:`batch_to` onto ``run.device``; the loss is
    read by ``float`` (which waits for the device); and a run that stops
    on an error still joins its in-flight write, so what it committed is
    on disk."""
    from repro_torch.runtime.fault_tolerance import HostFailure

    policy = policy or RecoveryPolicy()
    run: ElasticRun = build(None)
    recoveries = 0
    bad = 0  # consecutive non-finite losses
    slow = 0  # consecutive straggler watchdog trips
    history: list[dict] = []
    step = run.start
    pending = None  # in-flight async checkpoint write (ElasticRun.save)

    def _join_pending() -> None:
        """Wait for the in-flight checkpoint write.  This is THE join
        point: a writer-thread failure surfaces here (before the next
        commit / before a restore reads the directory / at the end) —
        never silently."""
        nonlocal pending
        if pending is not None:
            handle, pending = pending, None
            handle.join()

    def _commit(at_step: int, state) -> None:
        nonlocal pending
        _join_pending()
        handle = run.save(at_step, state)
        if handle is not None and hasattr(handle, "join"):
            pending = handle

    def _recover(survivors: int, why: str) -> None:
        nonlocal run, recoveries, bad, slow, step
        # The last committed write must be on disk before build() restores
        # from it (and a broken writer must not be papered over by
        # restoring something older).
        _join_pending()
        recoveries += 1
        if recoveries > policy.max_recoveries:
            raise RuntimeError(
                f"giving up after {policy.max_recoveries} recoveries ({why})")
        if policy.backoff_seconds:
            time.sleep(policy.backoff_seconds * 2 ** (recoveries - 1))
        log(f"[recover #{recoveries}] {why} -> rebuilding on "
            f"{survivors} device(s)")
        run = build(survivors)
        bad = 0
        slow = 0
        step = run.start

    try:
        while step < steps:
            try:
                t0 = time.time()
                if chaos is not None:
                    death = chaos.host_death(step, run.n_devices)
                    if death is not None:
                        raise HostFailure(dead=death[0], survivors=death[1])
                    chaos.on_step_start(step)  # straggle: counts into dt
                batch = batch_to(source(step), run.device)
                new_state, metrics = run.step_fn(run.state, batch)
                loss = float(metrics["loss"])
                dt = time.time() - t0
                if chaos is not None:
                    loss = chaos.poison_loss(step, loss)

                if run.heartbeat is not None:
                    run.heartbeat.beat(step)
                stale, survivors = [], 0
                if run.monitor is not None:
                    stale = run.monitor.stale_hosts()
                    if stale:
                        survivors = len(run.monitor.live_hosts()) * run.devices_per_host
                # A stale host aborts the step before the watchdog reads it.
                tripped = (not stale and run.watchdog is not None
                           and run.watchdog.observe(dt))
                host = run.heartbeat.host if run.heartbeat is not None else "straggler"
                trips = [host] if tripped else []
                if run.agree is not None:
                    stale, survivors, trips = run.agree(stale, survivors, trips)
                if stale:
                    raise HostFailure(dead=stale, survivors=survivors)
                if trips:
                    slow += 1
                    log(f"  [watchdog] step {step} straggled ({dt:.2f}s; "
                        f"trip {slow})")
                    # A log line nobody reads is not mitigation: after
                    # straggler_patience consecutive trips the slow host is
                    # treated as failed, so run_elastic actually evicts it
                    # (shrink + re-plan + restore) instead of limping forever.
                    if (policy.straggler_patience
                            and slow >= policy.straggler_patience):
                        # Evicting the only host degenerates to a same-size
                        # rebuild (a restart is the sole mitigation left).
                        survivors = max(run.devices_per_host,
                                        run.n_devices - run.devices_per_host * len(trips))
                        raise HostFailure(dead=trips, survivors=survivors)
                else:
                    slow = 0

                if not math.isfinite(loss):
                    bad += 1
                    log(f"  [guard] step {step}: non-finite loss — update "
                        f"skipped ({bad}/{policy.nonfinite_patience})")
                    history.append({"step": step, "loss": loss, "time": dt,
                                    "skipped": True})
                    if bad >= policy.nonfinite_patience:
                        _recover(run.n_devices,
                                 f"{bad} consecutive non-finite losses; rolling "
                                 "back to the last committed checkpoint")
                    else:
                        step += 1
                    continue

                bad = 0
                recoveries = 0  # the cap is on CONSECUTIVE recoveries:
                # a committed step in between proves real progress
                run.state = new_state  # committed only on a finite loss
                history.append({"step": step, "loss": loss, "time": dt,
                                "skipped": False})
                if step % run.log_every == 0 or step == steps - 1:
                    extra = "".join(
                        f"  {k} {float(metrics[k]):.3g}"
                        for k in ("grad_norm", "lr") if k in metrics)
                    log(f"step {step:5d}  loss {loss:.4f}{extra}  {dt:.2f}s")
                if (run.save is not None and run.ckpt_every
                        and step and step % run.ckpt_every == 0):
                    _commit(step, run.state)
                    if chaos is not None and run.ckpt_dir:
                        # Chaos corrupts the checkpoint just written — it must
                        # be on disk first (no overlap under chaos).
                        _join_pending()
                        torn = chaos.after_save(run.ckpt_dir, step)
                        if torn:
                            log(f"  [chaos] tore checkpoint chunk {torn}")
                step += 1
            except HostFailure as e:
                if run.on_failure is not None:
                    run.on_failure(step, e)
                _recover(e.survivors, f"host failure: dead={e.dead}")

        if run.save is not None:
            _commit(steps - 1, run.state)
            _join_pending()
    finally:
        # A run stopped by an error keeps what it committed.
        if pending is not None:
            handle, pending = pending, None
            handle.join()
    return run.state, history
