"""Continuous-batching serving engine over the bucket ladder — the JAX
package's ``serve/engine.py`` on one device.

The loop:

  QUEUED -> ACTIVE   admit up to the free KV-slot count, pad the group to
                     the nearest covering bucket, run that bucket's
                     prefill, scatter the cache rows into free slots
                     (first token comes from the prefill logits);
  ACTIVE -> ACTIVE   one per-slot decode step over the whole slot pool
                     per engine step (each slot at its own position);
  ACTIVE -> DONE     length / EOS reached: retire, free the slot, and the
                     next admit backfills it;
  * -> SHED/TIMEOUT  graceful degradation: the queue sheds on overflow,
                     deadlines expire both queued and active requests.

Everything shape-dependent happens in :meth:`Engine.warmup`, once: the
bucket schedules through ``plan.autotune``, the slot pool on the params'
device, and one run of every bucket prefill and of the slot decode (there
is nothing to compile; the runs move the device's lazy initialisation out
of the first request).  The request path (submit/step) never plans,
tunes, or meets a new shape; the tests spy on the autotuner's timing path
to prove it.

The pool is updated in place: the prefill's cache rows are copied into it
by a device-side index and each decode step writes its slots' rows.
"""

from __future__ import annotations

import dataclasses
import itertools
import time

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.registry import init_cache_slots
from repro_torch.runtime.serve import (
    make_bucket_prefill_step, make_slot_decode_step, params_device, torch_dtype,
)
from repro_torch.serve.bucket import Bucket, BucketLadder

# Request lifecycle states.
QUEUED = "queued"
ACTIVE = "active"
DONE = "done"
SHED = "shed"          # queue overflow or oversize prompt at submit
TIMEOUT = "timeout"    # deadline expired (queued or mid-generation)


class WallClock:
    """Real time; ``advance`` is a no-op (the world advances itself) and
    ``advance_to`` sleeps until the target."""

    virtual = False

    def now(self) -> float:
        return time.monotonic()

    def advance(self, dt: float) -> None:
        pass

    def advance_to(self, t: float) -> None:
        delta = t - self.now()
        if delta > 0:
            time.sleep(min(delta, 0.05))


class VirtualClock:
    """Deterministic time for the load generator: the loop advances it by
    the ladder's modeled step seconds, so batching composition, padding
    waste, and latency percentiles are reproducible bit-for-bit."""

    virtual = True

    def __init__(self, start: float = 0.0):
        self._t = float(start)

    def now(self) -> float:
        return self._t

    def advance(self, dt: float) -> None:
        self._t += max(0.0, float(dt))

    def advance_to(self, t: float) -> None:
        self._t = max(self._t, float(t))


@dataclasses.dataclass
class Request:
    """One generation request and its lifecycle record."""

    rid: str
    prompt: np.ndarray  # 1-D int32 token ids
    max_new_tokens: int
    deadline: float | None = None  # absolute clock time; None = no deadline
    state: str = QUEUED
    tokens: list = dataclasses.field(default_factory=list)
    slot: int | None = None
    t_submit: float | None = None
    t_admit: float | None = None
    t_first: float | None = None
    t_done: float | None = None

    @property
    def latency(self) -> float | None:
        if self.t_done is None or self.t_submit is None:
            return None
        return self.t_done - self.t_submit

    @property
    def ttft(self) -> float | None:
        if self.t_first is None or self.t_submit is None:
            return None
        return self.t_first - self.t_submit


class RequestQueue:
    """Bounded FIFO admission queue: overflow sheds (never blocks), and
    deadline-expired requests are dropped at the head before admit."""

    def __init__(self, max_depth: int = 64):
        self.max_depth = int(max_depth)
        self._q: list[Request] = []

    def __len__(self) -> int:
        return len(self._q)

    def submit(self, req: Request, now: float) -> bool:
        req.t_submit = now if req.t_submit is None else req.t_submit
        if len(self._q) >= self.max_depth:
            req.state = SHED
            return False
        if req.deadline is not None and now >= req.deadline:
            req.state = TIMEOUT
            req.t_done = now
            return False
        req.state = QUEUED
        self._q.append(req)
        return True

    def expire(self, now: float) -> list[Request]:
        """Drop (and return) every queued request whose deadline passed."""
        dead = [r for r in self._q if r.deadline is not None and now >= r.deadline]
        for r in dead:
            r.state = TIMEOUT
            r.t_done = now
        self._q = [r for r in self._q if r.state == QUEUED]
        return dead

    def peek(self, k: int) -> list[Request]:
        return self._q[:k]

    def pop(self, k: int) -> list[Request]:
        got, self._q = self._q[:k], self._q[k:]
        return got


@dataclasses.dataclass(frozen=True)
class StepInfo:
    """What one engine step did — the load generator's clock advances by
    the modeled cost of exactly these events."""

    prefills: tuple = ()       # (bucket, rows_admitted, true_prompt_tokens)
    decode_ran: bool = False
    decode_active: int = 0
    retired: tuple = ()        # rids finished this step
    timed_out: tuple = ()      # rids expired this step


class Engine:
    """Continuous-batching engine: bucket-planned prefill into a KV slot
    pool, per-slot decode over the active set, retire-and-backfill.

    ``warmup()`` must run before ``submit``/``step``; it resolves every
    bucket's schedules through the autotune cache (cache-only in
    production, tune on first boot), builds the bucket prefills and the
    slot decode, allocates the slot pool on the params' device via the
    family registry and runs every step once."""

    def __init__(self, cfg: ModelConfig, params, ladder: BucketLadder, *,
                 n_slots: int | None = None, queue_depth: int = 64,
                 compute_dtype="float32", cache_dtype=None,
                 clock=None,
                 eos_id: int | None = None):
        self.cfg = cfg
        self.params = params
        self.device = params_device(params)
        self.ladder = ladder
        self.n_slots = int(n_slots if n_slots is not None else ladder.max_batch)
        self.queue = RequestQueue(queue_depth)
        self.compute_dtype = compute_dtype
        self.cache_dtype = cache_dtype or compute_dtype
        self.clock = clock if clock is not None else WallClock()
        self.eos_id = eos_id
        self._rid = itertools.count()
        self._warmed = False
        self._slots: list[Request | None] = [None] * self.n_slots
        self.retired: list[Request] = []
        self.rejected: list[Request] = []
        # Padding-waste accounting: padded vs true token slots dispatched.
        self.stats = {"prefill_padded": 0, "prefill_true": 0,
                      "decode_slots": 0, "decode_active": 0, "steps": 0}

    # -- boot -------------------------------------------------------------

    def warmup(self, *, policy: str | None = None, cache=None) -> dict:
        """Resolve and run everything shape-dependent, once.  Returns the
        ladder's cell provenance map (bucket -> cell -> cached/tuned/
        modeled)."""
        dev = self.device
        sources = self.ladder.warmup(
            self.cfg, policy=policy, cache=cache,
            dtype=torch_dtype(self.compute_dtype), device=dev)
        self._prefill = {
            b: make_bucket_prefill_step(
                self.cfg, self.ladder.max_seq, self.compute_dtype,
                self.cache_dtype, schedules=self.ladder.plans[b],
                machine=self.ladder.machine)
            for b in self.ladder.buckets
        }
        decode_plans = self.ladder.plans[max(self.ladder.buckets,
                                             key=lambda b: b.batch)]
        self._decode = make_slot_decode_step(
            self.cfg, self.compute_dtype, schedules={
                k: v for k, v in decode_plans.items()
                if k.startswith("decode.")},
            machine=self.ladder.machine)
        self.cache = init_cache_slots(self.cfg, self.n_slots,
                                      self.ladder.max_seq,
                                      torch_dtype(self.cache_dtype), device=dev)
        self.tok = torch.zeros((self.n_slots,), dtype=torch.int32, device=dev)
        self.pos = torch.zeros((self.n_slots,), dtype=torch.int32, device=dev)
        # Run every bucket prefill and the decode step once on throwaway
        # inputs, so no request pays the device's lazy initialisation.
        for b in self.ladder.buckets:
            zt = torch.zeros((b.batch, b.seq), dtype=torch.int32, device=dev)
            zl = torch.ones((b.batch,), dtype=torch.int32, device=dev)
            self._prefill[b](self.params, zt, zl)
        self._decode(self.params, self.cache, self.tok, self.pos)
        for leaf in self.cache.values():  # the decode wrote at position 0
            leaf.zero_()
        if dev.type == "cuda":  # boot ends with the device's work done
            torch.cuda.synchronize(dev)
        self._warmed = True
        return sources

    # -- request intake ----------------------------------------------------

    def submit(self, req: Request | None = None, *, prompt=None,
               max_new_tokens: int = 16, deadline: float | None = None) -> Request:
        """Queue one request (or build one from ``prompt=``).  Oversize
        prompts and queue overflow shed immediately — check
        ``req.state``."""
        if not self._warmed:
            raise RuntimeError("Engine.warmup() has not run")
        now = self.clock.now()
        if req is None:
            req = Request(rid=f"r{next(self._rid)}",
                          prompt=np.asarray(prompt, np.int32).reshape(-1),
                          max_new_tokens=int(max_new_tokens),
                          deadline=deadline)
        if req.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if len(req.prompt) > self.ladder.max_prompt:
            req.state = SHED
            req.t_submit = now
            self.rejected.append(req)
            return req
        if not self.queue.submit(req, now):
            self.rejected.append(req)
        return req

    # -- the loop ----------------------------------------------------------

    @property
    def active(self) -> list[Request]:
        return [r for r in self._slots if r is not None]

    @property
    def idle(self) -> bool:
        return not self.active and not len(self.queue)

    def step(self) -> StepInfo:
        """One engine iteration: expire, admit+prefill, decode, retire."""
        if not self._warmed:
            raise RuntimeError("Engine.warmup() has not run")
        now = self.clock.now()
        timed_out = [r.rid for r in self.queue.expire(now)]
        timed_out += [r.rid for r in self._expire_active(now)]
        prefills, retired = self._admit(now)
        decode_ran, n_active, dec_retired = self._decode_step(now)
        retired += dec_retired
        self.stats["steps"] += 1
        return StepInfo(prefills=tuple(prefills), decode_ran=decode_ran,
                        decode_active=n_active, retired=tuple(retired),
                        timed_out=tuple(timed_out))

    def run_until_idle(self, max_steps: int = 100_000) -> None:
        for _ in range(max_steps):
            if self.idle:
                return
            self.step()
        raise RuntimeError(f"engine not idle after {max_steps} steps")

    # -- internals ---------------------------------------------------------

    def _expire_active(self, now: float) -> list[Request]:
        dead = []
        for i, r in enumerate(self._slots):
            if r is not None and r.deadline is not None and now >= r.deadline:
                r.state = TIMEOUT
                r.t_done = now
                r.slot = None
                self._slots[i] = None
                self.retired.append(r)
                dead.append(r)
        return dead

    def _admit(self, now: float):
        """Admit queued requests into free slots, one padded bucket
        dispatch per group, until slots or queue run out."""
        prefills, retired = [], []
        while True:
            free = [i for i, r in enumerate(self._slots) if r is None]
            if not free or not len(self.queue):
                break
            cand = self.queue.peek(min(len(free), self.ladder.max_batch))
            bucket = self.ladder.route(
                len(cand), max(len(r.prompt) for r in cand))
            # route() only returns None for oversize prompts, which
            # submit() already shed.
            grp = self.queue.pop(min(len(cand), bucket.batch))
            bucket = self.ladder.route(len(grp),
                                       max(len(r.prompt) for r in grp))
            slots = free[:len(grp)]
            self._prefill_group(grp, bucket, slots, now)
            prefills.append((bucket, len(grp),
                             sum(len(r.prompt) for r in grp)))
            retired += [r.rid for r in grp if r.state == DONE]
        return prefills, retired

    def _prefill_group(self, grp: list[Request], bucket: Bucket,
                       slots: list[int], now: float) -> None:
        n, dev = len(grp), self.device
        toks = np.zeros((bucket.batch, bucket.seq), np.int32)
        lens = np.ones((bucket.batch,), np.int32)
        for i, r in enumerate(grp):
            toks[i, :len(r.prompt)] = r.prompt
            lens[i] = len(r.prompt)
        cache_b, logits = self._prefill[bucket](
            self.params, torch.from_numpy(toks).to(dev), torch.from_numpy(lens).to(dev))
        first = torch.argmax(logits[:n], -1)
        idx = torch.as_tensor(slots, dtype=torch.long, device=dev)
        for name, full in self.cache.items():
            full[:, idx] = cache_b[name][:, :n].to(full.dtype)
        self.tok[idx] = first.to(torch.int32)
        self.pos[idx] = torch.from_numpy(lens[:n]).to(dev)
        first = first.cpu().numpy()
        self.stats["prefill_padded"] += bucket.batch * bucket.seq
        self.stats["prefill_true"] += int(lens[:n].sum())
        for i, r in enumerate(grp):
            r.state = ACTIVE
            r.slot = slots[i]
            r.t_admit = now
            r.t_first = now
            r.tokens.append(int(first[i]))
            self._slots[slots[i]] = r
            if self._finished(r):
                self._retire(r, now)

    def _decode_step(self, now: float):
        act = [(i, r) for i, r in enumerate(self._slots) if r is not None]
        if not act:
            return False, 0, []
        self.cache, logits = self._decode(self.params, self.cache,
                                          self.tok, self.pos)
        self.tok = torch.argmax(logits, -1).to(torch.int32)
        nxt = self.tok.cpu().numpy()
        live = np.zeros((self.n_slots,), np.int32)
        retired = []
        for i, r in act:
            live[i] = 1
            r.tokens.append(int(nxt[i]))
            if self._finished(r):
                self._retire(r, now)
                retired.append(r.rid)
        # Only live slots advance; freed/empty slots keep their position
        # (their cache rows are fully overwritten at the next prefill).
        self.pos += torch.from_numpy(live).to(self.device)
        self.stats["decode_slots"] += self.n_slots
        self.stats["decode_active"] += len(act)
        return True, len(act), retired

    def _finished(self, r: Request) -> bool:
        if len(r.tokens) >= r.max_new_tokens:
            return True
        return self.eos_id is not None and r.tokens[-1] == self.eos_id

    def _retire(self, r: Request, now: float) -> None:
        r.state = DONE
        r.t_done = now
        if r.slot is not None:
            self._slots[r.slot] = None
            r.slot = None
        self.retired.append(r)

    # -- the deterministic service-time model ------------------------------

    def modeled_step_seconds(self, info: StepInfo) -> float:
        """Modeled wall seconds of one step's dispatches — what a
        ``VirtualClock`` load run advances by (see loadgen)."""
        sec = 0.0
        for bucket, _, _ in info.prefills:
            sec += self.ladder.modeled_seconds(bucket, "prefill")
        if info.decode_ran:
            decode_bucket = max(self.ladder.buckets, key=lambda b: b.batch)
            sec += self.ladder.modeled_seconds(decode_bucket, "decode")
        return sec

    def padding_waste(self) -> float:
        """Fraction of dispatched token slots that were padding (prefill
        pad rows/columns + idle decode slots)."""
        padded = self.stats["prefill_padded"] + self.stats["decode_slots"]
        true = self.stats["prefill_true"] + self.stats["decode_active"]
        return 0.0 if padded == 0 else 1.0 - true / padded
