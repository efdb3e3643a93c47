"""Per-op planners: the paper's capacity argument, written once.

Every planner implements the same contract: given layer shapes and a
:class:`~repro_torch.core.machine.MachineModel`, emit the
:class:`~repro_torch.plan.schedule.Schedule` whose working set fits the
machine's local memory (after the DMA-stream reservation, paper Sec. 2.2.2)
and whose modeled main-memory words are smallest.  The same code yields the
paper's Manticore quotes (ConvPlanner: Delta_O = 24 sp / 12 dp on the running
example; MatmulPlanner: block_n = 768/384), the JAX package's TPU v5e picks,
and the thread-block tiles of the CUDA kernels on the H100, where the
machine's ``block_caps`` bound each block to what the kernel takes.  The
backward planners (dgrad, wgrad, dX, dW) reuse the forward capacity rule on
the transposed roles.

Traffic models are kernel-faithful: the conv model is ``alg2_strip_traffic``
generalized to rectangular planes, pooling and batch (filters re-stream once
per strip, zero-padding rows are free); the matmul model degenerates to
Alg 5's Eqs. (12-13) when block_m covers the batch.  Explicit ``block_*``
overrides are honored verbatim (clamped to legal ranges).
"""

from __future__ import annotations

import dataclasses
import math
from typing import ClassVar, Protocol, runtime_checkable

from repro_torch.core import ccr
from repro_torch.core.machine import H100, MachineModel
from repro_torch.plan.schedule import Schedule
from repro_torch.plan.sharded import MeshSpec, ShardCandidate, ShardedSchedule, mesh_spec


class PlanRejected(ValueError):
    """A planner refuses the shapes or pins it was given (an unknown
    algorithm, pins of two families, a geometry outside the kernel's
    contract).  The autotuner degrades to the modeled argmin on this error
    alone; an error a kernel raises propagates."""


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _align_down(x: int, m: int) -> int:
    return x // m * m


def _strip_ladder(H_O: int, floor: int) -> list[int]:
    """Strip-height candidates: H_O and its power-of-two fractions, rounded
    up to ``floor`` granularity, tallest first."""
    cands, k = [], 1
    while True:
        hb = round_up(-(-H_O // k), floor)
        if not cands or hb < cands[-1]:
            cands.append(hb)
        if hb <= floor:
            break
        k *= 2
    return cands


@runtime_checkable
class Planner(Protocol):
    """The planner contract: shapes in, one best Schedule out (a
    ShardedSchedule when the planner was constructed with a mesh)."""

    op: ClassVar[str]
    machine: MachineModel

    def plan(self, **shape) -> Schedule:  # pragma: no cover - protocol
        ...


@dataclasses.dataclass(frozen=True)
class ShardablePlanner:
    """Shared planner base: a machine, an optional mesh, and the sharded
    argmin.

    With ``mesh=None`` (the default) ``plan`` is the single-device capacity
    argument.  With a mesh, ``plan`` returns a :class:`ShardedSchedule`:
    the op's partition candidates (:meth:`_shard_candidates`: batch/stack
    for the conv, psum/ring/batch/tp for the matmul) are each planned
    locally on their per-device shapes, their mesh-total words split into
    HBM and interconnect, and the candidate with the fewest total modeled
    words wins — the paper's capacity argument, extended with a mesh axis.
    ``strategy=`` pins one candidate the way ``block_*`` pins pin a block.
    A single-device shard group degenerates to the meshless Schedule
    inside a trivial wrapper.
    """

    machine: MachineModel = H100
    mesh: MeshSpec | None = None
    shard_axis: str = "model"
    strategy: str | None = None

    def plan(self, **shape):
        if self.mesh is None:
            return self.plan_local(**shape)
        return self.plan_sharded(**shape)

    def plan_local(self, **shape) -> Schedule:  # pragma: no cover - abstract
        raise NotImplementedError

    # -- candidate enumeration (the argmin's search space, exposed) -------

    def local_candidates(self, **shape) -> list[Schedule]:
        """The single-device Schedules the argmin chooses between, one per
        point of the op's tunable ladder (each completed to its best
        remaining blocking).  The base planner has a one-point space; ops
        with a real search override this.  Used by ``candidates()`` and
        the measured-time autotuner (repro_torch.plan.autotune)."""
        return [self.plan_local(**shape)]

    def _ladder_candidates(self, name: str, floor: int, **shape) -> list[Schedule]:
        """Halving ladder over one block kwarg: the argmin's pick, then
        ``floor``-aligned halvings down to ``floor`` — each re-planned so
        the remaining blocks adapt.  An explicit pin collapses the ladder."""
        base = self.plan_local(**shape)
        if shape.get(name) is not None:
            return [base]
        out, seen = [], set()
        v = base.block(name)
        while True:
            s = self.plan_local(**{**shape, name: v})
            if s.blocks not in seen and s.fits(self.machine):
                out.append(s)
                seen.add(s.blocks)
            if v <= floor:
                break
            v = max(floor, _align_down(v // 2, floor) or floor)
        return out or [base]

    def candidates(self, **shape) -> list:
        """Every (Sharded)Schedule the planner's argmin considers, sorted
        by modeled words (the plan() winner first): the local blocking
        ladder; or, with a mesh, one locally-argmin'd ShardedSchedule per
        partition strategy (psum vs ring vs batch/stack..., honoring a
        ``strategy=`` pin) — the search space the measured-time autotuner
        benchmarks.  On the H100 the list holds only what the port's
        kernels launch: a candidate whose local schedule overflows a
        block's shared memory is dropped (the JAX package's ladders fall
        back to an unfit argmin, which the interpreter runs), and a list
        left empty is a rejection."""
        if self.mesh is None:
            cands = self.local_candidates(**shape)
        elif self.shard_group == 1:
            cands = [self.plan_sharded(**shape)]
        else:
            pin = self.strategy
            strategies = []
            for c in self._shard_candidates(self.shard_group, **shape):
                if c.strategy not in strategies and pin in (None, c.strategy):
                    strategies.append(c.strategy)
            if not strategies:
                self.plan_sharded(**shape)  # raises the argmin's error
            cands = [dataclasses.replace(self, strategy=st).plan_sharded(**shape)
                     for st in strategies]
        if self.machine.name == H100.name:
            cands = [s for s in cands if s.fits(self.machine)]
            if not cands:
                raise PlanRejected(f"{self.op}: no candidate fits one block's shared "
                                   f"memory at {shape}")

        def _rank(s):
            loc = s if isinstance(s, Schedule) else s.schedule
            return (s.modeled_words, loc.critical_path_steps)

        out, seen = [], set()
        for s in sorted(cands, key=_rank):
            loc = s if isinstance(s, Schedule) else s.schedule
            key = (getattr(s, "strategy", None),
                   getattr(loc, "algorithm", None), loc.grid, loc.blocks)
            if key not in seen:
                seen.add(key)
                out.append(s)
        return out

    @property
    def shard_group(self) -> int:
        """Extent of the partitioned mesh axis (1 when the mesh lacks it —
        the degenerate replicated case)."""
        if self.mesh is None or self.shard_axis not in self.mesh.axis_names:
            return 1
        return self.mesh.axis_size(self.shard_axis)

    def _shard_candidates(self, group: int, **shape) -> list[ShardCandidate]:
        """Partitionings this op can run; overridden per planner.  The
        base offers only full replication, so any op degenerates safely."""
        del group, shape
        return [ShardCandidate(strategy="single", local_shape={}, partition=())]

    def plan_sharded(self, **shape) -> ShardedSchedule:
        if self.mesh is None:
            raise PlanRejected("plan_sharded needs a mesh-bound planner")
        group = self.shard_group
        local_planner = dataclasses.replace(self, mesh=None, strategy=None)
        # A 1-wide shard group has nothing to partition: every strategy
        # degenerates to "single", so a pin is satisfied vacuously.
        pin = self.strategy if group > 1 else None
        best = None
        for cand in self._shard_candidates(group, **shape):
            if pin is not None and cand.strategy != pin:
                continue
            local = local_planner.plan(**{**shape, **cand.local_shape})
            if cand.hbm_override is not None:
                loads, stores = cand.hbm_override
            else:
                loads, stores = group * local.loads, group * local.stores
            macs = (cand.macs_override if cand.macs_override is not None
                    else group * local.macs)
            ss = ShardedSchedule(
                schedule=local, mesh=self.mesh, axis=self.shard_axis,
                strategy=cand.strategy, partition=cand.partition,
                hbm_loads=loads, hbm_stores=stores, ici_words=cand.ici_words,
                macs=macs)
            if best is None or ss.modeled_words < best.modeled_words:
                best = ss
        if best is None:
            raise PlanRejected(
                f"no {self.strategy!r} partitioning of {self.op!r} over mesh "
                f"axis {self.shard_axis!r} (group={group}) fits shapes {shape}")
        return best


# ---------------------------------------------------------------------------
# Conv (Algs 1/2 + strip tiling) and its im2col rival
# ---------------------------------------------------------------------------


def conv_strip_words(
    *, H_O: int, W_O: int, H_I: int, W_I: int, F: int, S: int, P: int,
    d_in: int, d_out: int, block_h: int, block_do: int,
    pool: int = 1, batch: int = 1,
) -> tuple[int, int]:
    """(loads, stores) of the strip-tiled stacked schedule.

    Each of the ceil(H_O/block_h) strips re-streams its halo'd input rows
    once per output stack (zero-padding rows cost nothing) and its filter
    slabs once per (strip, d_i, d_o); pooled outputs store once.
    """
    n_stacks = -(-d_out // block_do)
    n_strips = -(-H_O // block_h)
    h_in = (block_h - 1) * S + F
    rows = 0
    for h0 in range(0, H_O, block_h):
        lo = h0 * S - P
        rows += max(0, min(lo + h_in, H_I) - max(lo, 0))
    loads = n_stacks * d_in * rows * W_I + n_strips * d_out * d_in * F * F
    stores = (H_O // pool) * (W_O // pool) * d_out
    return batch * loads, batch * stores


@dataclasses.dataclass(frozen=True)
class ConvPlanner(ShardablePlanner):
    """The two-level conv argmin: ``algorithm x blocking`` (DESIGN.md Sec. 9).

    * **direct** — the strip-tiled stacked kernel.  Candidate strips are H_O
      and its power-of-two fractions (rounded up to the pool granularity);
      for each, the largest lane-aligned output stack whose working set fits
      is considered — the paper's Delta_O argument, two-dimensional.
    * **im2col** — the patch-matrix GEMM; its blocking is delegated to
      :class:`MatmulPlanner` on the per-strip GEMM
      ``[batch*block_h*W_O, F*F*d_in] @ [F*F*d_in, d_out]``.

    The fitting schedule with the fewest modeled words wins, ties toward
    direct.  ``algorithm=`` pins one family; a direct-family pin
    (``block_do``/``block_di``) or a GEMM-family pin (``block_m/n/k``)
    implies its family.
    """

    op: ClassVar[str] = "conv2d"

    _BDO_CAP: ClassVar[int] = 2048
    _BDI_CAP: ClassVar[int] = 512

    def default_block_di(self, d_in: int) -> int:
        lane = self.machine.lane
        if lane == 1:
            return 1  # the paper's per-slice `for d_i` loop
        return min(round_up(d_in, lane),
                   self.machine.block_cap("block_di", self._BDI_CAP))

    def _stream_bytes(self, hb: int, bdo: int, bdi: int, W_stream: int,
                      F: int, S: int, in_bytes: int) -> int:
        """Double-buffered input-strip + filter streams, when the machine
        holds streamed blocks in the budget."""
        if not self.machine.charge_stream_blocks:
            return 0
        h_halo = (hb - 1) * S + F
        return (h_halo * W_stream * bdi + F * F * bdi * bdo) * in_bytes * 2

    def _vmem_bytes(self, hb: int, bdo: int, bdi: int, W_O: int, W_stream: int,
                    F: int, S: int, in_bytes: int) -> int:
        acc_word = max(4, in_bytes)  # f32 accumulator (dp on dp machines)
        return (self._stream_bytes(hb, bdo, bdi, W_stream, F, S, in_bytes)
                + hb * W_O * bdo * acc_word)

    def _max_stack(self, hb: int, bdi: int, W_O: int, W_stream: int,
                   F: int, S: int, in_bytes: int, d_out: int) -> int:
        """Largest lane-aligned block_do fitting the budget at strip hb
        (0 when not even one lane of output slices fits)."""
        m = self.machine
        lane = m.lane
        budget = m.usable_for_working_set(streams=2)
        acc_word = max(4, in_bytes)
        fixed = per_bdo_stream = 0
        if m.charge_stream_blocks:
            h_halo = (hb - 1) * S + F
            fixed = h_halo * W_stream * bdi * in_bytes * 2
            per_bdo_stream = F * F * bdi * in_bytes * 2
        per_bdo = per_bdo_stream + hb * W_O * acc_word
        bdo = _align_down((budget - fixed) // per_bdo, lane) if budget > fixed else 0
        return min(bdo, m.block_cap("block_do", self._BDO_CAP),
                   round_up(d_out, lane))

    def _shard_candidates(self, group: int, *, d_out: int, batch: int = 1,
                          **shape) -> list[ShardCandidate]:
        # On a mesh the forward conv shards as pure data parallelism:
        # "batch" (each device convolves batch/P images) or "stack" (each
        # device owns D_O/P output slices), no interconnect words either
        # way; both apply to both algorithm families.  "single" is only the
        # fallback when nothing divides.
        del shape
        ax = self.shard_axis
        rep4 = (None, None, None, None)
        cands = []
        if group > 1 and batch % group == 0:
            cands.append(ShardCandidate(
                "batch", {"batch": batch // group},
                ((ax, None, None, None), rep4, (None,), (ax, None, None, None))))
        if group > 1 and d_out % group == 0:
            cands.append(ShardCandidate(
                "stack", {"d_out": d_out // group},
                (rep4, (None, None, None, ax), (ax,), (None, None, None, ax))))
        return cands or [ShardCandidate("single", {}, (rep4, rep4, (None,), rep4))]

    def plan_local(
        self, *, H_O: int, W_O: int, F: int, S: int = 1, d_in: int, d_out: int,
        in_bytes: int = 2, block_di: int | None = None, pool: int = 1,
        batch: int = 1, padding: int | None = None,
        H_I: int | None = None, W_I: int | None = None,
        block_h: int | None = None, block_do: int | None = None,
        algorithm: str | None = None, block_m: int | None = None,
        block_n: int | None = None, block_k: int | None = None,
    ) -> Schedule:
        """The two-level argmin: each family's best blocking, then the
        fitting family with fewer modeled words (ties toward direct)."""
        if algorithm not in (None, "direct", "im2col"):
            raise PlanRejected(f"unknown conv algorithm {algorithm!r}; "
                             "expected 'direct' or 'im2col'")
        direct_pins = block_do is not None or block_di is not None
        gemm_pins = (block_m is not None or block_n is not None
                     or block_k is not None)
        if direct_pins and gemm_pins:
            raise PlanRejected(
                "block_do/block_di pin the direct kernel and "
                "block_m/block_n/block_k pin the im2col GEMM — they cannot "
                "be combined in one conv plan")
        if algorithm is None:  # a family-specific pin implies its family
            if direct_pins:
                algorithm = "direct"
            elif gemm_pins:
                algorithm = "im2col"
        if algorithm == "direct" and gemm_pins:
            raise PlanRejected("direct conv has no block_m/block_n/block_k")
        if algorithm == "im2col" and direct_pins:
            raise PlanRejected("im2col conv has no block_do/block_di")
        shape = dict(H_O=H_O, W_O=W_O, F=F, S=S, d_in=d_in, d_out=d_out,
                     in_bytes=in_bytes, pool=pool, batch=batch,
                     padding=padding, H_I=H_I, W_I=W_I, block_h=block_h)
        if algorithm == "im2col":
            return self._plan_im2col(**shape, block_m=block_m,
                                     block_n=block_n, block_k=block_k)
        direct = self._plan_direct(**shape, block_di=block_di,
                                   block_do=block_do)
        if algorithm == "direct":
            return direct
        im2col = self._plan_im2col(**shape, block_m=block_m,
                                   block_n=block_n, block_k=block_k)
        if im2col.fits(self.machine) and (
                im2col.modeled_words < direct.modeled_words
                or not direct.fits(self.machine)):
            return im2col
        return direct

    def _plan_direct(
        self, *, H_O: int, W_O: int, F: int, S: int = 1, d_in: int, d_out: int,
        in_bytes: int = 2, block_di: int | None = None, pool: int = 1,
        batch: int = 1, padding: int | None = None,
        H_I: int | None = None, W_I: int | None = None,
        block_h: int | None = None, block_do: int | None = None,
    ) -> Schedule:
        m = self.machine
        lane = m.lane
        P = 0 if padding is None else padding
        H_I = H_I if H_I is not None else (H_O - 1) * S + F - 2 * P
        W_I = W_I if W_I is not None else (W_O - 1) * S + F - 2 * P
        W_stream = (W_O - 1) * S + F  # streamed (padded) strip width
        bdi = block_di or self.default_block_di(d_in)

        def words(hb: int, bdo: int) -> int:
            loads, stores = conv_strip_words(
                H_O=H_O, W_O=W_O, H_I=H_I, W_I=W_I, F=F, S=S, P=P,
                d_in=d_in, d_out=d_out, block_h=hb, block_do=bdo,
                pool=pool, batch=batch,
            )
            return loads + stores

        def clamp_h(hb: int) -> int:
            return round_up(min(hb, round_up(H_O, pool)), pool)

        if block_h is not None and block_do is not None:
            hb, bdo = block_h, block_do
        else:
            # Candidate strips: H_O and its power-of-two fractions down to
            # the pool granularity, tallest first — or just the pinned strip.
            cands = [clamp_h(block_h)] if block_h is not None else _strip_ladder(H_O, pool)
            budget = m.usable_for_working_set(streams=2)
            best = None
            for hb in cands:
                if block_do is not None:
                    bdo = min(block_do, round_up(d_out, lane))
                    if self._vmem_bytes(hb, bdo, bdi, W_O, W_stream, F, S,
                                        in_bytes) > budget:
                        continue  # pinned stack doesn't fit at this strip
                else:
                    bdo = self._max_stack(hb, bdi, W_O, W_stream, F, S,
                                          in_bytes, d_out)
                    if bdo < max(lane, 1):
                        continue  # nothing fits at this strip height
                w = words(hb, bdo)
                if best is None or w < best[0]:
                    best = (w, hb, bdo)
            if best is None:  # nothing fits the model; smallest legal tile
                hb = block_h if block_h is not None else round_up(min(8, H_O), pool)
                bdo = block_do if block_do is not None else lane
            else:
                _, hb, bdo = best
        hb = clamp_h(hb)
        bdo = min(bdo, round_up(d_out, lane))

        loads, stores = conv_strip_words(
            H_O=H_O, W_O=W_O, H_I=H_I, W_I=W_I, F=F, S=S, P=P,
            d_in=d_in, d_out=d_out, block_h=hb, block_do=bdo,
            pool=pool, batch=batch,
        )
        n_h = -(-H_O // hb)
        grid = (batch, n_h, round_up(d_out, bdo) // bdo, round_up(d_in, bdi) // bdi)
        return Schedule(
            op=self.op,
            grid=grid,
            blocks=(("block_di", bdi), ("block_do", bdo), ("block_h", hb)),
            halo=max(0, F - S),
            macs=batch * H_O * W_O * F * F * d_in * d_out,
            loads=loads,
            stores=stores,
            vmem_bytes=self._vmem_bytes(hb, bdo, bdi, W_O, W_stream, F, S, in_bytes),
            machine=m.name,
            critical_path_steps=ccr.grid_steps(grid),
        )

    def _plan_im2col(
        self, *, H_O: int, W_O: int, F: int, S: int = 1, d_in: int,
        d_out: int, in_bytes: int = 2, pool: int = 1, batch: int = 1,
        padding: int | None = None, H_I: int | None = None,
        W_I: int | None = None, block_h: int | None = None,
        block_m: int | None = None, block_n: int | None = None,
        block_k: int | None = None,
    ) -> Schedule:
        """The im2col-GEMM family's best blocking: per candidate strip, the
        GEMM blocking is delegated to :class:`MatmulPlanner` on the strip's
        patch matmul."""
        del padding, H_I, W_I
        mm = MatmulPlanner(self.machine)
        k = F * F * d_in

        def build(hb: int) -> Schedule:
            hb = round_up(min(hb, round_up(H_O, pool)), pool)
            inner = mm.plan_local(
                m=batch * min(hb, H_O) * W_O, n=d_out, k=k,
                in_bytes=in_bytes, block_m=block_m, block_n=block_n,
                block_k=block_k)
            t = ccr.conv_im2col_traffic(
                H_O=H_O, W_O=W_O, F=F, S=S, d_in=d_in, d_out=d_out,
                block_h=hb, block_m=inner.block("block_m"),
                block_n=inner.block("block_n"),
                block_k=inner.block("block_k"), pool=pool, batch=batch)
            grid = (-(-H_O // hb),) + inner.grid
            return Schedule(
                op=self.op,
                grid=grid,
                blocks=tuple(sorted((("block_h", hb),) + inner.blocks)),
                halo=0,
                macs=t.macs,
                loads=t.main_loads,
                stores=t.main_stores,
                vmem_bytes=inner.vmem_bytes,
                machine=self.machine.name,
                algorithm="im2col",
                critical_path_steps=ccr.grid_steps(grid),
            )

        if block_h is not None:
            return build(block_h)
        best = None
        for hb in _strip_ladder(H_O, pool):
            s = build(hb)
            if not s.fits(self.machine):
                continue
            if best is None or s.modeled_words < best.modeled_words:
                best = s
        return best or build(_strip_ladder(H_O, pool)[-1])

    def local_candidates(self, **shape) -> list[Schedule]:
        """Both families' ladders: one candidate per (algorithm, strip
        height) of the two-level search, each completed to its family's
        best remaining blocking, fits-filtered — the crossover autotune
        measures for real.  An ``algorithm=`` pin (explicit or implied by
        a family-specific block pin) collapses to one family."""
        if shape.get("block_h") is not None:
            return [self.plan_local(**shape)]
        alg = shape.get("algorithm")
        if alg is None:
            if shape.get("block_do") is not None or shape.get("block_di") is not None:
                alg = "direct"
            elif any(shape.get(b) is not None
                     for b in ("block_m", "block_n", "block_k")):
                alg = "im2col"
        algs = ("direct", "im2col") if alg is None else (alg,)
        pool = shape.get("pool") or 1
        out, seen = [], set()
        for hb in _strip_ladder(shape["H_O"], pool):
            for a in algs:
                s = self.plan_local(**{**shape, "block_h": hb,
                                       "algorithm": a})
                key = (s.algorithm, s.blocks)
                if key not in seen and s.fits(self.machine):
                    out.append(s)
                    seen.add(key)
        return out or [self.plan_local(**shape)]


@dataclasses.dataclass(frozen=True)
class Im2colConvPlanner(ConvPlanner):
    """The im2col-GEMM conv as its own op: the ConvPlanner with the
    algorithm pinned to "im2col"."""

    op: ClassVar[str] = "conv2d_im2col"

    def plan_local(self, **shape) -> Schedule:
        return super().plan_local(**{**shape, "algorithm": "im2col"})

    def local_candidates(self, **shape) -> list[Schedule]:
        return super().local_candidates(**{**shape, "algorithm": "im2col"})


# ---------------------------------------------------------------------------
# Conv backward: dgrad (input gradient) and wgrad (filter gradient)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ConvDgradPlanner(ShardablePlanner):
    """Plans the conv backward-data (dgrad) kernel.

    dX is a stride-1 strip conv over the S-dilated gradient with spatially
    flipped, channel-swapped filters — exactly the forward kernel on a
    transposed geometry — so the planner delegates to :class:`ConvPlanner`
    (direct family) on that geometry and relabels the schedule.  Kwargs
    are the *forward* layer's shapes: ``(H_O, W_O)`` is the gradient
    extent, ``d_in/d_out`` the forward channel counts.

    With ``pool=`` (the forward layer saved its pool-argmax/ReLU mask) the
    default variant is **fused_epilogue**: the mask-scatter prologue
    (``ccr.epilogue_scatter_traffic``, charged here once) rebuilds the
    full-rate dY, and the d_out stream is folded inside each grid step, so
    the grid drops its stream dimension and the critical path shortens to
    ``ccr.conv_dgrad_fused_steps``.  Both variants run the same kernel with
    the same numerics; ``algorithm="direct"`` pins the plain schedule.
    """

    op: ClassVar[str] = "conv2d_dgrad"

    def _shard_candidates(self, group: int, *, batch: int = 1,
                          **shape) -> list[ShardCandidate]:
        del shape
        ax = self.shard_axis
        rep4 = (None, None, None, None)
        cands = []
        if group > 1 and batch % group == 0:  # dX shards with the batch
            cands.append(ShardCandidate(
                "batch", {"batch": batch // group},
                ((ax, None, None, None), rep4, (ax, None, None, None))))
        return cands or [ShardCandidate("single", {}, (rep4, rep4, rep4))]

    def plan_local(
        self, *, H_O: int, W_O: int, F: int, S: int = 1, P: int = 0,
        d_in: int, d_out: int, in_bytes: int = 2, batch: int = 1,
        H_I: int | None = None, W_I: int | None = None,
        block_h: int | None = None, block_do: int | None = None,
        block_di: int | None = None, pool: int | None = None,
        algorithm: str | None = None,
    ) -> Schedule:
        if P > F - 1:
            raise PlanRejected(f"dgrad needs padding <= F-1, got P={P} for F={F}")
        if algorithm not in (None, "direct", "fused_epilogue"):
            raise PlanRejected(f"unknown dgrad algorithm {algorithm!r}; "
                             "expected 'direct' or 'fused_epilogue'")
        if algorithm == "fused_epilogue" and not pool:
            raise PlanRejected("fused_epilogue dgrad needs the forward pool "
                             "factor (pool=)")
        if algorithm is None:
            algorithm = "fused_epilogue" if pool else "direct"
        H_dil, W_dil = (H_O - 1) * S + 1, (W_O - 1) * S + 1  # dilated grad
        pt = F - 1 - P  # transposed padding
        H_I = H_I if H_I is not None else H_dil + 2 * pt - F + 1
        W_I = W_I if W_I is not None else W_dil + 2 * pt - F + 1
        inner = ConvPlanner(self.machine).plan(
            H_O=H_I, W_O=W_I, F=F, S=1, d_in=d_out, d_out=d_in,
            in_bytes=in_bytes, batch=batch, padding=pt, H_I=H_dil, W_I=W_dil,
            block_h=block_h, block_do=block_do, block_di=block_di,
            algorithm="direct",
        )
        if algorithm == "direct":
            return dataclasses.replace(inner, op=self.op)
        sc = ccr.epilogue_scatter_traffic(
            H_O=H_O, W_O=W_O, d_out=d_out, pool=pool, batch=batch,
            in_bytes=in_bytes)
        return dataclasses.replace(
            inner, op=self.op, algorithm="fused_epilogue",
            grid=inner.grid[:3],
            loads=inner.loads + sc.main_loads,
            stores=inner.stores + sc.main_stores,
            critical_path_steps=ccr.conv_dgrad_fused_steps(
                H_I=H_I, d_in=d_in, block_h=inner.block("block_h"),
                block_do=inner.block("block_do"), batch=batch),
        )

    def local_candidates(self, **shape) -> list[Schedule]:
        """Strip ladder over the dX extent (the transposed geometry's
        output plane), each delegated through the forward search — and,
        when the forward saved a mask residual (``pool=``), both the
        fused_epilogue and direct variants per strip."""
        if shape.get("block_h") is not None:
            return [self.plan_local(**shape)]
        F, S, P = shape["F"], shape.get("S", 1), shape.get("P", 0)
        H_I = shape.get("H_I")
        if H_I is None:
            H_I = (shape["H_O"] - 1) * S + 1 + 2 * (F - 1 - P) - F + 1
        alg = shape.get("algorithm")
        if alg is not None:
            algs = (alg,)
        elif shape.get("pool"):
            algs = ("fused_epilogue", "direct")
        else:
            algs = ("direct",)
        out, seen = [], set()
        for hb in _strip_ladder(H_I, 1):
            for a in algs:
                s = self.plan_local(**{**shape, "block_h": hb,
                                       "algorithm": a})
                key = (s.algorithm, s.blocks)
                if key not in seen and s.fits(self.machine):
                    out.append(s)
                    seen.add(key)
        return out or [self.plan_local(**shape)]


def conv_wgrad_words(
    *, H_O: int, W_O: int, H_I: int, W_I: int, F: int, S: int, P: int,
    d_in: int, d_out: int, block_h: int, block_di: int, block_do: int,
    batch: int = 1,
) -> tuple[int, int]:
    """(loads, stores) of the wgrad accumulation schedule: the F^2 x
    Delta_I x Delta_O filter-gradient accumulator is the resident stack;
    each of the ceil(d_out/block_do) gradient stacks re-streams every
    halo'd input strip (zero-padding rows free) and each of the
    ceil(d_in/block_di) input blocks re-streams the whole gradient; dW
    stores exactly once."""
    n_do = -(-d_out // block_do)
    n_di = -(-d_in // block_di)
    h_in = (block_h - 1) * S + F
    rows = 0
    for h0 in range(0, H_O, block_h):
        lo = h0 * S - P
        rows += max(0, min(lo + h_in, H_I) - max(lo, 0))
    loads = n_do * d_in * rows * W_I + n_di * d_out * H_O * W_O
    stores = F * F * d_in * d_out
    return batch * loads, stores


@dataclasses.dataclass(frozen=True)
class ConvWgradPlanner(ShardablePlanner):
    """Picks (block_h, block_do, block_di) for the wgrad accumulation
    kernel: dW[ky, kx] += X_strip^T @ dY_strip over the (batch, strip)
    sweep.  The resident output stack is the F^2 * block_di * block_do f32
    accumulator; the input and gradient strips stream through.  Strip
    candidates are H_O and its power-of-two fractions, the largest fitting
    lane-aligned gradient stack per strip, fewest modeled words wins.

    Two execution variants share that blocking and its words: **direct**
    walks the whole (d_i, d_o, batch, strip) grid, **pipelined** folds the
    (batch, strip) sweep inside each (d_i, d_o) step behind double-buffered
    strip copies.  The words tie, so the argmin over (words, critical-path
    steps) picks pipelined whenever the folded sweep is longer than one
    step; ``algorithm=`` pins a variant.
    """

    op: ClassVar[str] = "conv2d_wgrad"

    _BDO_CAP: ClassVar[int] = 2048
    _BDI_CAP: ClassVar[int] = 512

    def default_block_di(self, d_in: int) -> int:
        lane = self.machine.lane
        if lane == 1:
            return 1  # the paper's per-slice loop granularity
        return min(round_up(d_in, lane),
                   self.machine.block_cap("block_di", self._BDI_CAP))

    def _vmem_bytes(self, hb: int, bdo: int, bdi: int, F: int, S: int,
                    W_O: int, W_stream: int, in_bytes: int) -> int:
        acc_word = max(4, in_bytes)
        stream = 0
        if self.machine.charge_stream_blocks:
            h_halo = (hb - 1) * S + F
            stream = (h_halo * W_stream * bdi + hb * W_O * bdo) * in_bytes * 2
        return F * F * bdi * bdo * acc_word + stream

    def _max_stack(self, hb: int, bdi: int, F: int, S: int, W_O: int,
                   W_stream: int, in_bytes: int, d_out: int) -> int:
        m = self.machine
        lane = m.lane
        budget = m.usable_for_working_set(streams=2)
        acc_word = max(4, in_bytes)
        fixed = 0
        per_bdo = F * F * bdi * acc_word
        if m.charge_stream_blocks:
            h_halo = (hb - 1) * S + F
            fixed = h_halo * W_stream * bdi * in_bytes * 2
            per_bdo += hb * W_O * in_bytes * 2
        bdo = _align_down((budget - fixed) // per_bdo, lane) if budget > fixed else 0
        return min(bdo, m.block_cap("block_do", self._BDO_CAP),
                   round_up(d_out, lane))

    def _shard_candidates(self, group: int, *, F: int, d_in: int, d_out: int,
                          batch: int = 1, **shape) -> list[ShardCandidate]:
        # Each device accumulates a private dF over its images; Alg 4's
        # tree reduction of the private dFs is the interconnect bill.
        del shape
        ax = self.shard_axis
        rep4 = (None, None, None, None)
        cands = []
        if group > 1 and batch % group == 0:
            cands.append(ShardCandidate(
                "batch", {"batch": batch // group},
                ((ax, None, None, None), (ax, None, None, None), rep4),
                ici_words=ccr.tree_reduce_words(group, F * F * d_in * d_out)))
        return cands or [ShardCandidate("single", {}, (rep4, rep4, rep4))]

    def plan_local(
        self, *, H_O: int, W_O: int, F: int, S: int = 1, d_in: int,
        d_out: int, in_bytes: int = 2, batch: int = 1,
        padding: int | None = None, H_I: int | None = None,
        W_I: int | None = None, block_h: int | None = None,
        block_do: int | None = None, block_di: int | None = None,
        algorithm: str | None = None,
    ) -> Schedule:
        if algorithm not in (None, "direct", "pipelined"):
            raise PlanRejected(f"unknown wgrad algorithm {algorithm!r}; "
                             "expected 'direct' or 'pipelined'")
        m = self.machine
        lane = m.lane
        P = 0 if padding is None else padding
        H_I = H_I if H_I is not None else (H_O - 1) * S + F - 2 * P
        W_I = W_I if W_I is not None else (W_O - 1) * S + F - 2 * P
        W_stream = (W_O - 1) * S + F
        bdi = block_di or self.default_block_di(d_in)

        def words(hb: int, bdo: int) -> int:
            loads, stores = conv_wgrad_words(
                H_O=H_O, W_O=W_O, H_I=H_I, W_I=W_I, F=F, S=S, P=P,
                d_in=d_in, d_out=d_out, block_h=hb, block_di=bdi,
                block_do=bdo, batch=batch,
            )
            return loads + stores

        if block_h is not None and block_do is not None:
            hb, bdo = block_h, block_do
        else:
            cands = ([block_h] if block_h is not None
                     else _strip_ladder(H_O, 1))
            budget = m.usable_for_working_set(streams=2)
            best = None
            for hb in cands:
                if block_do is not None:
                    bdo = min(block_do, round_up(d_out, lane))
                    if self._vmem_bytes(hb, bdo, bdi, F, S, W_O, W_stream,
                                        in_bytes) > budget:
                        continue
                else:
                    bdo = self._max_stack(hb, bdi, F, S, W_O, W_stream,
                                          in_bytes, d_out)
                    if bdo < max(lane, 1):
                        continue
                w = words(hb, bdo)
                if best is None or w < best[0]:
                    best = (w, hb, bdo)
            if best is None:
                hb = block_h if block_h is not None else min(8, H_O)
                bdo = block_do if block_do is not None else lane
            else:
                _, hb, bdo = best
        hb = max(1, min(hb, H_O))
        bdo = min(bdo, round_up(d_out, lane))

        loads, stores = conv_wgrad_words(
            H_O=H_O, W_O=W_O, H_I=H_I, W_I=W_I, F=F, S=S, P=P,
            d_in=d_in, d_out=d_out, block_h=hb, block_di=bdi,
            block_do=bdo, batch=batch,
        )
        step_kw = dict(H_O=H_O, d_in=d_in, d_out=d_out, block_h=hb,
                       block_di=bdi, block_do=bdo, batch=batch)
        if algorithm is None:
            # The words tie, so the argmin reduces to the step term.
            pipelined = (ccr.conv_wgrad_steps(**step_kw, pipelined=True)
                         < ccr.conv_wgrad_steps(**step_kw, pipelined=False))
            algorithm = "pipelined" if pipelined else "direct"
        n_di = round_up(d_in, bdi) // bdi
        n_do = round_up(d_out, bdo) // bdo
        if algorithm == "pipelined":
            grid = (n_di, n_do)
        else:
            grid = (n_di, n_do, batch, -(-H_O // hb))
        return Schedule(
            op=self.op,
            grid=grid,
            blocks=(("block_di", bdi), ("block_do", bdo), ("block_h", hb)),
            halo=max(0, F - S),
            macs=batch * H_O * W_O * F * F * d_in * d_out,
            loads=loads,
            stores=stores,
            vmem_bytes=self._vmem_bytes(hb, bdo, bdi, F, S, W_O, W_stream,
                                        in_bytes),
            machine=m.name,
            algorithm=algorithm,
            critical_path_steps=ccr.conv_wgrad_steps(
                **step_kw, pipelined=(algorithm == "pipelined")),
        )

    def local_candidates(self, **shape) -> list[Schedule]:
        """One candidate per (gradient-strip height, variant): each strip
        with its best fitting gradient stack, in both the pipelined and
        direct execution variants — the wgrad argmin's search space."""
        if shape.get("block_h") is not None:
            return [self.plan_local(**shape)]
        alg = shape.get("algorithm")
        algs = ("pipelined", "direct") if alg is None else (alg,)
        out, seen = [], set()
        for hb in _strip_ladder(shape["H_O"], 1):
            for a in algs:
                s = self.plan_local(**{**shape, "block_h": hb,
                                       "algorithm": a})
                key = (s.algorithm, s.blocks)
                if key not in seen and s.fits(self.machine):
                    out.append(s)
                    seen.add(key)
        return out or [self.plan_local(**shape)]


# ---------------------------------------------------------------------------
# Matmul (Algs 4/5)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MatmulPlanner(ShardablePlanner):
    """Picks (block_m, block_n, block_k) for the FC matmul kernel.

    block_m/block_k sit at the machine's preferred sizes; block_n — the
    Delta_O output stack — grows until the working set (x block + w block
    streams, f32 accumulator) exhausts the budget: the Alg 5 strategy
    verbatim.  On MANTICORE (streams uncharged, lane 1) the same rule is
    exactly ``alg45_max_stack``: block_n <= 768 (sp) / 384 (dp) at batch 32.
    """

    op: ClassVar[str] = "matmul"

    _BN_CAP: ClassVar[int] = 2048
    _BMK_CAP: ClassVar[int] = 512

    def _vmem_bytes(self, bm: int, bn: int, bk: int, in_bytes: int) -> int:
        acc_word = max(4, in_bytes)
        stream = (bm * bk + bk * bn) * in_bytes * 2 if self.machine.charge_stream_blocks else 0
        return stream + bm * bn * acc_word

    def _shard_candidates(self, group: int, *, m: int, n: int, k: int,
                          **shape) -> list[ShardCandidate]:
        # "batch" (rows sharded, no collective), "psum" (Alg 4: K sharded,
        # private partial outputs tree-reduced), "ring" (Alg 3: K-sharded X
        # permuted around the ring while each device keeps its full-K
        # weight columns; every X word loaded from main memory once) and
        # "tp" (W columns sharded, X replicated, the output shards
        # gathered).
        del shape
        ax = self.shard_axis
        rep2 = (None, None)
        cands = []
        if group > 1 and m % group == 0:
            cands.append(ShardCandidate("batch", {"m": m // group},
                                        ((ax, None), rep2, (ax, None))))
        if group > 1 and k % group == 0:
            cands.append(ShardCandidate(
                "psum", {"k": k // group}, ((None, ax), (ax, None), rep2),
                ici_words=ccr.tree_reduce_words(group, m * n)))
        if group > 1 and k % group == 0 and n % group == 0:
            ring = ccr.ring_traffic(m=m, n=n, k=k, devices=group)
            cands.append(ShardCandidate(
                "ring", {"n": n // group}, ((None, ax), (None, ax), (None, ax)),
                ici_words=ring.intercluster,
                hbm_override=(ring.main_loads, ring.main_stores),
                macs_override=ring.macs))
        if group > 1 and n % group == 0:
            cands.append(ShardCandidate(
                "tp", {"n": n // group}, ((None, None), (None, ax), (None, ax)),
                ici_words=ccr.tree_reduce_words(group, m * n)))
        return cands or [ShardCandidate("single", {}, (rep2, rep2, rep2))]

    def plan_local(
        self, *, m: int, n: int, k: int, in_bytes: int = 2,
        block_m: int | None = None, block_n: int | None = None,
        block_k: int | None = None,
    ) -> Schedule:
        mm = self.machine
        lane = mm.lane
        budget = mm.usable_for_working_set(streams=2)
        bm = block_m or min(round_up(m, lane), mm.block_cap("block_m", self._BMK_CAP))
        bk = block_k or min(round_up(k, lane), mm.block_cap("block_k", self._BMK_CAP))
        if block_n is not None:
            bn = block_n
        else:
            acc_word = max(4, in_bytes)
            fixed = per_bn = 0
            if mm.charge_stream_blocks:
                fixed = bm * bk * in_bytes * 2
                per_bn = bk * in_bytes * 2
            per_bn += bm * acc_word
            bn = _align_down(max(0, budget - fixed) // per_bn, lane)
            bn = max(lane, min(bn, mm.block_cap("block_n", self._BN_CAP),
                               round_up(n, lane)))

        mp, np_, kp = round_up(m, bm), round_up(n, bn), round_up(k, bk)
        # Alg 5 device analogue: x re-streams once per output stack
        # (n-block), w once per m-block, outputs store once.
        loads = (np_ // bn) * mp * kp + (mp // bm) * kp * np_
        stores = mp * np_
        grid = (mp // bm, np_ // bn, kp // bk)
        return Schedule(
            op=self.op,
            grid=grid,
            blocks=(("block_k", bk), ("block_m", bm), ("block_n", bn)),
            halo=0,
            macs=mp * np_ * kp,
            loads=loads,
            stores=stores,
            vmem_bytes=self._vmem_bytes(bm, bn, bk, in_bytes),
            machine=mm.name,
            critical_path_steps=ccr.grid_steps(grid),
        )

    def local_candidates(self, **shape) -> list[Schedule]:
        """Halving ladder over block_n — the Delta_O output stack the
        capacity argument maximizes (the budget max, then halves)."""
        return self._ladder_candidates("block_n", self.machine.lane, **shape)


# ---------------------------------------------------------------------------
# Matmul backward: dX = G @ W^T and dW = X^T @ G
# ---------------------------------------------------------------------------


def _relabel_matmul(inner: Schedule, op: str, names: dict[str, str]) -> Schedule:
    """Rename an inner MatmulPlanner schedule's blocks into the backward
    kernel's own (forward-role) names; grid and model fields carry over."""
    blocks = tuple(sorted((names[k], v) for k, v in inner.blocks))
    return dataclasses.replace(inner, op=op, blocks=blocks)


@dataclasses.dataclass(frozen=True)
class MatmulDxPlanner(ShardablePlanner):
    """Plans dX = dY @ W^T for the FC layer.

    A matmul whose resident output stack is the K (input-feature)
    dimension while N streams through as the contraction — Alg 5's
    capacity rule with the roles transposed — so the planner delegates to
    :class:`MatmulPlanner` on ``(m, k, n)`` and relabels the blocks back
    into forward names: ``block_k`` is the output stack, ``block_n`` the
    streamed contraction step.  Kwargs are the *forward* shapes (x: [m, k],
    w: [k, n], dY: [m, n]).

    ``algorithm="fused_dxdw"`` models the fused dX/dW kernel instead: one
    sweep over (k-blocks, n-blocks, m-blocks) reads each dY tile once and
    feeds both contractions, saving dW's dY stream but holding a whole-M
    dX strip in local memory.  The schedule carries the combined cost of
    both gradients; the FC layer opts in by pinning the algorithm in
    ``plan_bwd`` and falls back to the pair when it does not fit.
    """

    op: ClassVar[str] = "matmul_dx"

    def _fuse_dxdw(self, sched: Schedule, *, m: int, n: int, k: int,
                   in_bytes: int) -> Schedule:
        """Re-model a direct dX schedule as the fused dX/dW kernel: the dY
        tile is charged once per step (n_k * M * N), W re-streams per
        m-block, X per n-block; both gradients store once.  Local memory
        holds two stages of the three streamed tiles, the whole-M f32 dX
        strip of the current k-block and the dW tile."""
        blocks = dict(sched.blocks)
        bm, bk, bn = blocks["block_m"], blocks["block_k"], blocks["block_n"]
        mp, kp, np_ = round_up(m, bm), round_up(k, bk), round_up(n, bn)
        n_k, n_n, n_m = kp // bk, np_ // bn, mp // bm
        grid = (n_k, n_n, n_m)
        stream = 0
        if self.machine.charge_stream_blocks:
            stream = (bm * bn + bk * bn + bm * bk) * in_bytes * 2
        return dataclasses.replace(
            sched,
            algorithm="fused_dxdw",
            grid=grid,
            macs=2 * mp * np_ * kp,
            loads=n_k * mp * np_ + n_m * kp * np_ + n_n * mp * kp,
            stores=mp * kp + kp * np_,
            vmem_bytes=stream + (mp * bk + bk * bn) * 4,
            critical_path_steps=ccr.grid_steps(grid),
        )

    def _shard_candidates(self, group: int, *, m: int, **shape) -> list[ShardCandidate]:
        del shape  # dX shards with the batch: each device its own rows
        ax = self.shard_axis
        rep2 = (None, None)
        cands = []
        if group > 1 and m % group == 0:
            cands.append(ShardCandidate("batch", {"m": m // group},
                                        ((ax, None), rep2, (ax, None))))
        return cands or [ShardCandidate("single", {}, (rep2, rep2, rep2))]

    def plan_local(
        self, *, m: int, n: int, k: int, in_bytes: int = 2,
        block_m: int | None = None, block_n: int | None = None,
        block_k: int | None = None, algorithm: str | None = None,
    ) -> Schedule:
        if algorithm not in (None, "direct", "fused_dxdw"):
            raise PlanRejected(
                f"matmul_dx algorithm must be 'direct' or 'fused_dxdw', "
                f"got {algorithm!r}")
        inner = MatmulPlanner(self.machine).plan(
            m=m, n=k, k=n, in_bytes=in_bytes,
            block_m=block_m, block_n=block_k, block_k=block_n,
        )
        sched = _relabel_matmul(inner, self.op, {
            "block_m": "block_m", "block_n": "block_k", "block_k": "block_n",
        })
        if (algorithm or "direct") == "direct":
            return sched
        return self._fuse_dxdw(sched, m=m, n=n, k=k, in_bytes=in_bytes)

    def local_candidates(self, **shape) -> list[Schedule]:
        """Halving ladder over block_k — dX's resident output stack — for
        the direct kernel and the fused dX/dW variant (a pinned
        ``algorithm`` collapses to that variant's ladder)."""
        pin = shape.pop("algorithm", None)
        algs = ("direct", "fused_dxdw") if pin is None else (pin,)
        out, seen = [], set()
        for alg in algs:
            for s in self._ladder_candidates(
                    "block_k", self.machine.lane, algorithm=alg, **shape):
                key = (s.algorithm, s.blocks)
                if key not in seen:
                    seen.add(key)
                    out.append(s)
        return out


@dataclasses.dataclass(frozen=True)
class MatmulDwPlanner(ShardablePlanner):
    """Plans dW = X^T @ dY for the FC layer: output [k, n] tiles resident
    while the M (batch) dimension streams as the contraction.  Delegates
    to :class:`MatmulPlanner` on ``(k, n, m)``; ``block_m`` is the streamed
    contraction step in the relabeled schedule.  Kwargs are the *forward*
    shapes."""

    op: ClassVar[str] = "matmul_dw"

    def _shard_candidates(self, group: int, *, m: int, n: int, k: int,
                          **shape) -> list[ShardCandidate]:
        # "batch" shards the contraction: each device a private dW over its
        # rows, tree-reduced as ici_words.
        del shape
        ax = self.shard_axis
        rep2 = (None, None)
        cands = []
        if group > 1 and m % group == 0:
            cands.append(ShardCandidate(
                "batch", {"m": m // group}, ((ax, None), (ax, None), rep2),
                ici_words=ccr.tree_reduce_words(group, k * n)))
        return cands or [ShardCandidate("single", {}, (rep2, rep2, rep2))]

    def plan_local(
        self, *, m: int, n: int, k: int, in_bytes: int = 2,
        block_m: int | None = None, block_n: int | None = None,
        block_k: int | None = None,
    ) -> Schedule:
        inner = MatmulPlanner(self.machine).plan(
            m=k, n=n, k=m, in_bytes=in_bytes,
            block_m=block_k, block_n=block_n, block_k=block_m,
        )
        return _relabel_matmul(inner, self.op, {
            "block_m": "block_k", "block_n": "block_n", "block_k": "block_m",
        })

    def local_candidates(self, **shape) -> list[Schedule]:
        """Halving ladder over block_n — the streamed half of dW's
        resident [block_k, block_n] accumulator tile."""
        return self._ladder_candidates("block_n", self.machine.lane, **shape)


# ---------------------------------------------------------------------------
# Flash attention (beyond-paper, same methodology)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AttentionPlanner(ShardablePlanner):
    """Picks (block_q, block_kv) for the flash-attention kernel.

    The q block with its f32 accumulator and (m, l) statistics is the
    resident output stack; K/V stream through like the paper's input depth
    slices.  Blocks start at 128 (clamped to the sequence rounded up to 8
    rows) and halve until the working set fits — the capacity rule,
    downward.  Explicit blocks are honored (clamped to the rounded
    sequence).  On the H100 the working set is exactly the kernel's shared
    memory (``kernels/flash_attention/flash_attention.py::smem_bytes``).
    """

    op: ClassVar[str] = "flash_attention"

    _SUBLANE: ClassVar[int] = 8
    _CAP: ClassVar[int] = 128

    def _vmem_bytes(self, bq: int, bkv: int, head_dim: int, in_bytes: int) -> int:
        stream = 0
        if self.machine.charge_stream_blocks:
            # q block + double-buffered k and v blocks.
            stream = (bq * head_dim + 2 * bkv * head_dim) * in_bytes * 2
        return stream + bq * head_dim * 4 + 2 * bq * 4  # acc + (m, l)

    @staticmethod
    def kv_blocks_run(q0: int, bq: int, bkv: int, n_kvb: int,
                      causal: bool, window: int | None) -> int:
        """KV blocks the kernel runs for the q block starting at row ``q0``:
        the closed form of its block-level causal/window skips (the CUDA
        kernel's KV loop runs exactly these)."""
        hi = n_kvb - 1
        if causal:  # kernel: k_start <= q_start + bq - 1
            hi = min(hi, (q0 + bq - 1) // bkv)
        lo = 0
        if window is not None:  # kernel: k_start + bkv - 1 > q_start - window
            lo = max(0, -(-(q0 - window + 2 - bkv) // bkv))
        return max(0, hi - lo + 1)

    def plan_local(
        self, *, seq_q: int, seq_kv: int, head_dim: int,
        n_q_heads: int = 1, n_kv_heads: int = 1, batch: int = 1,
        in_bytes: int = 4, block_q: int | None = None,
        block_kv: int | None = None, causal: bool = False,
        window: int | None = None,
    ) -> Schedule:
        sub = self._SUBLANE
        auto = block_q is None and block_kv is None
        bq = min(block_q or self._CAP, round_up(seq_q, sub))
        bkv = min(block_kv or self._CAP, round_up(seq_kv, sub))
        if auto:
            budget = self.machine.usable_for_working_set(streams=2)
            while (self._vmem_bytes(bq, bkv, head_dim, in_bytes) > budget
                   and max(bq, bkv) > sub):
                if bkv >= bq:
                    bkv = max(sub, round_up(bkv // 2, sub))
                else:
                    bq = max(sub, round_up(bq // 2, sub))

        sqp, skvp = round_up(seq_q, bq), round_up(seq_kv, bkv)
        bhq = batch * n_q_heads
        n_qb = sqp // bq
        n_kvb = skvp // bkv
        # q loads once per row block; every q block of every query head
        # streams its KV head's K and V blocks that survive the causal/window
        # skips (GQA sharing saves no device-memory traffic: each query head
        # fetches again).  With no mask this is the dense n_qb * skvp bound.
        run_blocks = sum(
            self.kv_blocks_run(qi * bq, bq, bkv, n_kvb, causal, window)
            for qi in range(n_qb)
        )
        loads = bhq * (sqp * head_dim + run_blocks * bkv * head_dim * 2)
        stores = bhq * sqp * head_dim
        return Schedule(
            op=self.op,
            critical_path_steps=ccr.grid_steps((bhq, n_qb, n_kvb)),
            grid=(bhq, n_qb, n_kvb),
            blocks=(("block_kv", bkv), ("block_q", bq)),
            halo=0,
            macs=bhq * run_blocks * bq * bkv * head_dim * 2,
            loads=loads,
            stores=stores,
            vmem_bytes=self._vmem_bytes(bq, bkv, head_dim, in_bytes),
            machine=self.machine.name,
        )

    def local_candidates(self, **shape) -> list[Schedule]:
        """The argmin's (block_q, block_kv) pick plus the sublane-aligned
        halvings of each — the small 2-D neighbourhood the downward
        capacity rule walks.  On the H100 only the blocks the flash kernel
        is built for at this head_dim stay (a stated divergence: ``repro``'s
        kernel takes any); a head_dim it is not built for has none."""
        if (shape.get("block_q") is not None
                or shape.get("block_kv") is not None):
            out = [self.plan_local(**shape)]
        else:
            base = self.plan_local(**shape)
            bq, bkv = base.block("block_q"), base.block("block_kv")
            sub = self._SUBLANE
            out, seen = [base], {base.blocks}
            for q2, kv2 in ((bq, bkv // 2), (bq // 2, bkv), (bq // 2, bkv // 2)):
                if q2 < sub or kv2 < sub:
                    continue
                s = self.plan_local(**{**shape, "block_q": round_up(q2, sub),
                                       "block_kv": round_up(kv2, sub)})
                if s.blocks not in seen and s.fits(self.machine):
                    out.append(s)
                    seen.add(s.blocks)
        if self.machine.name != H100.name:
            return out
        import torch

        from repro_torch.kernels.flash_attention.flash_attention import supported_blocks

        D = shape["head_dim"]
        dtype = torch.bfloat16 if shape.get("in_bytes") == 2 else torch.float32
        out = [s for s in out
               if supported_blocks(s.block("block_q"), s.block("block_kv"), D, dtype)]
        if not out:
            raise PlanRejected(f"the flash kernel is not built for head_dim {D} "
                               f"({dtype}, or not at the pinned blocks)")
        return out


# ---------------------------------------------------------------------------
# MoE expert FFN
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MoeFfnPlanner(ShardablePlanner):
    """Plans the MoE expert-FFN block: E experts, each a two-GEMM FFN on
    its capacity rows.

    The capacity-factor dispatch of ``models/moe.py`` fixes each expert's
    row count at ``cap = ceil(top_k * tokens / n_experts *
    capacity_factor)``, so the local schedule is E repetitions of two
    delegated :class:`MatmulPlanner` GEMMs — up ``[cap, d_model] @
    [d_model, d_ff]`` and down ``[cap, d_ff] @ [d_ff, d_model]`` — the
    compound-planner pattern again.

    On a mesh two partitionings compete, as in the JAX package: "batch"
    (tokens sharded, experts replicated — every device streams all E
    experts' weights on its token shard, no interconnect words) and "ep"
    (experts sharded E/P a device, weights streamed once, the routed rows
    crossing the interconnect twice as an all-to-all;
    ``ccr.moe_all_to_all_words``).  What ``models/moe.py`` executes on a
    mesh is another route (ROADMAP queue 3, a mirrored fault): it picks
    its branch by ``E % 16``, routes redundantly on every model rank and
    sums the partial outputs with one psum, moving no routed row.
    """

    op: ClassVar[str] = "moe_ffn"

    @staticmethod
    def expert_capacity(tokens: int, n_experts: int, top_k: int,
                        capacity_factor: float) -> int:
        """Rows per expert under the capacity dispatch — the
        ``models/moe.py`` formula."""
        return max(1, math.ceil(top_k * tokens / n_experts * capacity_factor))

    def _shard_candidates(self, group: int, *, tokens: int, n_experts: int,
                          d_model: int, top_k: int = 2,
                          **shape) -> list[ShardCandidate]:
        del shape
        ax = self.shard_axis
        rep2, rep3 = (None, None), (None, None, None)
        cands = []
        if group > 1 and tokens % group == 0:
            cands.append(ShardCandidate(
                "batch", {"tokens": tokens // group}, ((ax, None), rep3, (ax, None))))
        if (group > 1 and tokens % group == 0 and n_experts % group == 0
                and (tokens // group * top_k) % n_experts == 0):
            cands.append(ShardCandidate(
                "ep", {"tokens": tokens // group, "n_experts": n_experts // group},
                ((ax, None), (ax, None, None), (ax, None)),
                ici_words=ccr.moe_all_to_all_words(
                    tokens=tokens, d_model=d_model, top_k=top_k, n_experts=n_experts,
                    devices=group)))
        return cands or [ShardCandidate("single", {}, (rep2, rep3, rep2))]

    def plan_local(
        self, *, tokens: int, d_model: int, d_ff: int, n_experts: int,
        top_k: int = 2, capacity_factor: float = 1.0, in_bytes: int = 4,
        block_m: int | None = None, block_n: int | None = None,
        block_k: int | None = None,
    ) -> Schedule:
        cap = self.expert_capacity(tokens, n_experts, top_k, capacity_factor)
        mm = MatmulPlanner(self.machine)
        up = mm.plan_local(m=cap, n=d_ff, k=d_model, in_bytes=in_bytes,
                           block_m=block_m, block_n=block_n, block_k=block_k)
        down = mm.plan_local(m=cap, n=d_model, k=d_ff, in_bytes=in_bytes,
                             block_m=block_m, block_n=block_n, block_k=block_k)
        # The expert loop runs both GEMMs back to back with one shared
        # pipeline fill; the grid records the up GEMM's walk under the
        # expert dimension (the down GEMM's steps ride the critical path).
        grid = (n_experts,) + up.grid
        steps = 1 + n_experts * ((ccr.grid_steps(up.grid) - 1)
                                 + (ccr.grid_steps(down.grid) - 1))
        return Schedule(
            op=self.op,
            grid=grid,
            blocks=up.blocks,
            halo=0,
            macs=n_experts * (up.macs + down.macs),
            loads=n_experts * (up.loads + down.loads),
            stores=n_experts * (up.stores + down.stores),
            vmem_bytes=max(up.vmem_bytes, down.vmem_bytes),
            machine=self.machine.name,
            critical_path_steps=steps,
        )

    def local_candidates(self, **shape) -> list[Schedule]:
        """Halving ladder over block_n — the delegated GEMMs' Delta_O
        output stack."""
        return self._ladder_candidates("block_n", self.machine.lane, **shape)


# ---------------------------------------------------------------------------
# Transformer block (compound planner: the whole wing through delegation)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TransformerBlockPlanner(ShardablePlanner):
    """Plans a transformer block as a dict of delegated cells — the
    compound-planner pattern of :class:`Im2colConvPlanner`, one level up.
    It plans no op of its own: ``cell_planners`` hands each cell to its
    planner, bound to this machine and mesh, with the shard axis and a
    ``strategy=`` pin passed straight through, so on a mesh every cell is
    its own ShardedSchedule argmin.  ``plan()`` returns ``{cell_name:
    (Sharded)Schedule}`` keyed the way ``models/transformer.py`` consumes
    them, and ``candidates()`` each cell's ranked list.

    Every matmul cell (the fused qkv projection, the attention output
    projection, the fused gate+up and the down MLP GEMMs, the logits head)
    delegates to :class:`MatmulPlanner` on its ``[tokens, k] @ [k, n]``
    shape; the attention cell delegates to :class:`AttentionPlanner`; with
    ``n_experts > 0`` the MLP cells are replaced by one
    :class:`MoeFfnPlanner` cell, "moe".

    The head dim is ``head_dim`` where the caller names one, else
    ``d_model // n_heads``.  A stated divergence: the JAX package always
    plans ``d_model // n_heads``, so a config whose ``head_dim`` differs
    (qwen3-32b: 128 run, 80 planned; gemma3-4b: 256 run, 320 planned)
    plans other shapes there than its forward launches.  The port's
    ``models.transformer.plan_forward`` passes the config's
    ``resolved_head_dim``; a call that names no head dim equals the JAX
    package's field for field.

    ``seq_q`` (default ``seq``) is the attention cell's query length where
    a rank attends a slice of the queries to every key (the planned
    sequence-parallel attention: ``seq / tp`` rows against ``seq``).  The
    attention cell's modeled words then cost a causal slice as if it began
    at row 0, not at its offset (ROADMAP queue 3).
    """

    op: ClassVar[str] = "transformer_block"

    def cell_planners(self, *, batch: int, seq: int, d_model: int,
                      n_heads: int, d_ff: int, n_kv_heads: int | None = None,
                      vocab: int = 0, n_experts: int = 0, top_k: int = 2,
                      capacity_factor: float = 1.0, in_bytes: int = 4,
                      causal: bool = True, head_dim: int | None = None,
                      seq_q: int | None = None) -> dict[str, tuple]:
        """(planner, shape-kwargs) per cell — the delegation table."""
        hq = n_heads
        hkv = n_kv_heads or n_heads
        dh = head_dim or d_model // hq
        m = batch * seq
        bind = dict(machine=self.machine, mesh=self.mesh, shard_axis=self.shard_axis,
                    strategy=self.strategy)
        mm = MatmulPlanner(**bind)
        cells: dict[str, tuple] = {
            "qkv": (mm, dict(m=m, n=(hq + 2 * hkv) * dh, k=d_model,
                             in_bytes=in_bytes)),
            "attn": (AttentionPlanner(**bind),
                     dict(seq_q=seq_q or seq, seq_kv=seq, head_dim=dh,
                          n_q_heads=hq, n_kv_heads=hkv, batch=batch,
                          in_bytes=in_bytes, causal=causal)),
            "wo": (mm, dict(m=m, n=d_model, k=hq * dh, in_bytes=in_bytes)),
        }
        if n_experts:
            cells["moe"] = (MoeFfnPlanner(**bind),
                            dict(tokens=m, d_model=d_model, d_ff=d_ff,
                                 n_experts=n_experts, top_k=top_k,
                                 capacity_factor=capacity_factor, in_bytes=in_bytes))
        else:
            # gate and up share one fused GEMM (one x stream for both).
            cells["mlp_up"] = (mm, dict(m=m, n=2 * d_ff, k=d_model, in_bytes=in_bytes))
            cells["mlp_down"] = (mm, dict(m=m, n=d_model, k=d_ff, in_bytes=in_bytes))
        if vocab:
            cells["logits"] = (mm, dict(m=m, n=vocab, k=d_model,
                                        in_bytes=in_bytes))
        return cells

    def plan(self, **shape) -> dict:
        return {name: planner.plan(**kw)
                for name, (planner, kw) in self.cell_planners(**shape).items()}

    def candidates(self, **shape) -> dict:
        """Per-cell candidate enumeration: ``{cell: [ranked candidates]}``
        — each cell's own argmin search space (the autotuner tunes cells
        independently, as it does conv stages)."""
        return {name: planner.candidates(**kw)
                for name, (planner, kw) in self.cell_planners(**shape).items()}


PLANNERS: dict[str, type] = {
    ConvPlanner.op: ConvPlanner,
    Im2colConvPlanner.op: Im2colConvPlanner,
    ConvDgradPlanner.op: ConvDgradPlanner,
    ConvWgradPlanner.op: ConvWgradPlanner,
    MatmulPlanner.op: MatmulPlanner,
    MatmulDxPlanner.op: MatmulDxPlanner,
    MatmulDwPlanner.op: MatmulDwPlanner,
    AttentionPlanner.op: AttentionPlanner,
    MoeFfnPlanner.op: MoeFfnPlanner,
    TransformerBlockPlanner.op: TransformerBlockPlanner,
}


def planner_for(op: str, machine: MachineModel = H100, mesh=None,
                shard_axis: str = "model", strategy: str | None = None) -> Planner:
    """The registered planner for an op name, bound to a machine — and,
    when ``mesh`` is given (a MeshSpec, a live mesh, a dict or (name, size)
    pairs), to a mesh: its ``plan`` then emits a ShardedSchedule whose
    partitioning over ``shard_axis`` is chosen by modeled words (or pinned
    with ``strategy=``)."""
    try:
        cls = PLANNERS[op]
    except KeyError:
        raise KeyError(f"no planner registered for op {op!r}; "
                       f"known: {sorted(PLANNERS)}") from None
    return cls(machine, None if mesh is None else mesh_spec(mesh), shard_axis, strategy)
