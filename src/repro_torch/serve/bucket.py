"""Bucket ladder: the serving plan artifact — the JAX package's
``serve/bucket.py``.

A server sees arbitrary (batch, prompt-length) request shapes, but the
paper's whole argument is that the winning blocking schedule is
shape-dependent — so per-request planning is wasted work.  The standard
move (vLLM/TGI-style serving, here built on ``repro_torch.plan``) is a
small ladder of pre-planned (batch, seq) buckets:

  * every bucket's prefill and decode cells (qkv/attention/mlp/logits as
    planner shapes) are resolved **once at warmup** through
    :func:`repro_torch.plan.autotune.warm` — cache-only in production,
    tune on first boot (on the card that times the matmul and
    flash-attention kernels) — so the request path never plans, times, or
    meets a new shape;
  * request batches are padded up and routed to the nearest covering
    bucket (:meth:`BucketLadder.route`), trading padded tokens for a
    bounded set of shapes;
  * the resolved schedules' ``modeled_words`` give a deterministic
    service-time model (:meth:`modeled_seconds`) — what the virtual-clock
    load generator advances by.

On a mesh (``mesh=``, a MeshSpec), cells resolve to ``ShardedSchedule``s
(the planner's partition argmin per bucket shape) the same way; under
"tune" a multi-device candidate is timed on a live ``run_mesh`` or through
its per-device proxy (``plan.autotune``), every rank alike.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.machine import H100, MachineModel
from repro_torch.plan import autotune


@dataclasses.dataclass(frozen=True, order=True)
class Bucket:
    """One rung of the ladder: requests are padded up to this shape."""

    batch: int
    seq: int  # padded prompt length (positions beyond it are decode-only)

    def __post_init__(self):
        if self.batch < 1 or self.seq < 1:
            raise ValueError(f"bucket dims must be >= 1, got {self}")


# The per-layer cells of one bucket, as planner shapes.  Prefill runs the
# bucket's padded [batch, seq] token block against the full cache extent;
# decode runs one token per slot.  The logits head only projects the last
# position per row in prefill (the step builder gathers it), so its m is
# the row count, not batch*seq.
def bucket_cells(cfg: ModelConfig, bucket: Bucket, max_seq: int,
                 in_bytes: int = 4) -> dict[str, tuple[str, dict]]:
    """``{cell_name: (op_name, planner_shape)}`` for one bucket — the unit
    :func:`repro_torch.plan.autotune.warm` resolves at server boot."""
    d, v = cfg.d_model, cfg.vocab
    hq = cfg.n_heads or 1
    hkv = cfg.n_kv_heads or hq
    dh = cfg.resolved_head_dim
    cells: dict[str, tuple[str, dict]] = {}
    for phase, sq in (("prefill", bucket.seq), ("decode", 1)):
        m = bucket.batch * sq
        cells[f"{phase}.qkv"] = ("matmul", dict(
            m=m, n=(hq + 2 * hkv) * dh, k=d, in_bytes=in_bytes))
        cells[f"{phase}.attn"] = ("flash_attention", dict(
            seq_q=sq, seq_kv=max_seq, head_dim=dh, n_q_heads=hq,
            n_kv_heads=hkv, batch=bucket.batch, in_bytes=in_bytes,
            causal=True))
        cells[f"{phase}.mlp"] = ("matmul", dict(
            m=m, n=cfg.d_ff, k=d, in_bytes=in_bytes))
        cells[f"{phase}.logits"] = ("matmul", dict(
            m=bucket.batch, n=v, k=d, in_bytes=in_bytes))
    return cells


class BucketLadder:
    """A sorted ladder of :class:`Bucket` rungs with warmup-resolved plans.

    ``warmup(cfg)`` must run before :attr:`plans` / ``modeled_seconds`` are
    usable; the Engine calls it at boot and never resolves afterwards.
    """

    def __init__(self, buckets, *, max_seq: int,
                 machine: MachineModel = H100, mesh=None,
                 axis: str = "model", in_bytes: int = 4):
        rungs = sorted({b if isinstance(b, Bucket) else Bucket(*b)
                        for b in buckets}, key=lambda b: (b.seq, b.batch))
        if not rungs:
            raise ValueError("a BucketLadder needs at least one bucket")
        for b in rungs:
            if b.seq > max_seq:
                raise ValueError(f"bucket {b} exceeds max_seq={max_seq}")
        self.buckets: tuple[Bucket, ...] = tuple(rungs)
        self.max_seq = int(max_seq)
        self.machine = machine
        self.mesh = mesh
        self.axis = axis
        self.in_bytes = int(in_bytes)
        self.plans: dict[Bucket, dict] = {}
        self.sources: dict[Bucket, dict] = {}
        self._n_layers: int | None = None

    # -- routing ----------------------------------------------------------

    @property
    def max_batch(self) -> int:
        return max(b.batch for b in self.buckets)

    @property
    def max_prompt(self) -> int:
        return max(b.seq for b in self.buckets)

    def route(self, n: int, prompt_len: int) -> Bucket | None:
        """The cheapest rung covering ``n`` rows of ``prompt_len`` tokens:
        the smallest covering (seq, batch); when no rung has enough rows,
        the widest rung that covers the length (callers admit ``batch``
        rows now and come back for the rest).  ``None`` when the prompt is
        longer than every rung (reject at submit)."""
        covers = [b for b in self.buckets if b.seq >= prompt_len]
        if not covers:
            return None
        roomy = [b for b in covers if b.batch >= n]
        if roomy:
            return min(roomy, key=lambda b: (b.seq, b.batch))
        return max(covers, key=lambda b: (b.batch, -b.seq))

    # -- warmup resolution -------------------------------------------------

    def warmup(self, cfg: ModelConfig, *, policy: str | None = None,
               cache=None, dtype=torch.float32, device=None,
               run_mesh=None) -> dict[Bucket, dict]:
        """Resolve every bucket's cells once through the autotune cache
        (``plan.autotune.warm``; under policy "tune" a miss is timed on
        ``device``, the card unless set, and a multi-device candidate on
        ``run_mesh`` or through its per-device proxy).  Returns
        ``sources``: per bucket, each cell's resolution provenance
        ("cached" / "tuned" / "modeled").  The policy defaults to the
        process-wide one (``autotune.set_policy``), so callers name it."""
        self._n_layers = cfg.n_layers
        for b in self.buckets:
            cells = bucket_cells(cfg, b, self.max_seq, self.in_bytes)
            plans, sources = autotune.warm(
                cells, machine=self.machine, mesh=self.mesh, axis=self.axis,
                policy=policy, cache=cache, dtype=dtype, device=device,
                run_mesh=run_mesh)
            self.plans[b] = plans
            self.sources[b] = sources
        return self.sources

    @property
    def planned(self) -> bool:
        return len(self.plans) == len(self.buckets)

    # -- the deterministic service-time model ------------------------------

    def modeled_words(self, bucket: Bucket, phase: str) -> int:
        """Modeled main-memory words of one full ``phase`` step on one
        bucket: per-layer cells (qkv/attn/mlp) times n_layers, plus the
        one logits projection."""
        if not self.planned or self._n_layers is None:
            raise RuntimeError("BucketLadder.warmup(cfg) has not run")
        plans = self.plans[bucket]
        per_layer = sum(plans[f"{phase}.{c}"].modeled_words
                        for c in ("qkv", "attn", "mlp"))
        return per_layer * self._n_layers + plans[f"{phase}.logits"].modeled_words

    def modeled_seconds(self, bucket: Bucket, phase: str) -> float:
        """Modeled wall seconds of one step (words x word size over the
        machine's main-memory bandwidth) — the virtual clock's increment."""
        words = self.modeled_words(bucket, phase)
        return words * self.in_bytes / self.machine.main_mem_bw
