"""`ShardedSchedule`: device partitioning as a planner *output*.

A planner handed a ``(MachineModel, MeshSpec)`` pair emits a
:class:`ShardedSchedule` — a per-device
:class:`~repro_torch.plan.schedule.Schedule` plus the mesh shape, the chosen
partitioning of every operand, and the modeled words split into per-mesh
main-memory (``hbm_*``) and interconnect (``ici_words``) counts — so the
multi-cluster half of the paper (Alg 3's ring reuse of input depth slices,
Alg 4's tree reduction of private FC outputs) is *consumed* from the plan
by ``core/ring.py``, ``fc_layer_sharded`` and the ops' sharded impls, never
re-derived at a call site.

Conventions (as in the JAX package):

  * ``hbm_loads``/``hbm_stores`` are **shard-group totals**: summed over
    the ``devices`` of the partitioned mesh axis.  Every strategy is
    device-symmetric, so per-device counts are the totals divided by
    ``devices``.  Other mesh axes replicate the plan.
  * ``ici_words`` is the shard-group-total interconnect traffic:
    ring-permute words for "ring", the Alg-4 tree-reduction words for
    "psum" and the batch-contraction strategies, zero for pure data/stack
    parallelism.
  * A **single-device mesh degenerates exactly**: the wrapped ``schedule``
    equals the meshless planner's Schedule, ``hbm_* == schedule.loads/
    stores`` and ``ici_words == 0``.

Everything here is frozen and hashable, so sharded plans key the
registry's plan cache.  :class:`P` stands in for ``jax.sharding
.PartitionSpec``: a tuple of per-dimension entries, each ``None``
(replicated), a mesh axis name, or a tuple of axis names.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core import ccr
from repro_torch.core.machine import MachineModel
from repro_torch.plan.schedule import Schedule

# Per-operand partition entries: one tuple per operand (outputs last), one
# entry per array dimension — ``None`` (replicated) or the mesh axis name.
Partition = tuple[tuple[str | None, ...], ...]


class P(tuple):
    """A partition spec: one entry per array dimension, ``None``
    (replicated), an axis name, or a tuple of axis names (outermost
    first).  Equal to another spec (or a plain tuple) with the same
    entries, as ``PartitionSpec`` compares."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Hashable description of a device mesh (names and sizes only): to a
    live :class:`~repro_torch.runtime.collectives.Mesh` what a Schedule is
    to a kernel launch.  Build one from a live mesh with
    :func:`mesh_spec`."""

    axes: tuple[tuple[str, int], ...]

    def __post_init__(self):
        for _, n in self.axes:
            if n <= 0:
                raise ValueError(f"mesh axis sizes must be positive: {self.axes}")

    @property
    def devices(self) -> int:
        n = 1
        for _, s in self.axes:
            n *= s
        return n

    def axis_size(self, name: str) -> int:
        for k, s in self.axes:
            if k == name:
                return s
        raise KeyError(f"mesh {self.axes} has no axis {name!r}")

    @property
    def axis_names(self) -> tuple[str, ...]:
        return tuple(k for k, _ in self.axes)

    def with_axis(self, name: str, size: int) -> "MeshSpec":
        """A copy with one axis resized (elastic re-mesh: the data axis
        shrinks to the survivors, everything else is untouched)."""
        if name not in self.axis_names:
            raise KeyError(f"mesh {self.axes} has no axis {name!r}")
        return MeshSpec(axes=tuple((k, size if k == name else s) for k, s in self.axes))

    def shrink_to(self, n_devices: int, preserve: tuple[str, ...] = ("model",)) -> "MeshSpec":
        """The largest mesh of the same axes fitting ``n_devices``
        survivors, preserving the extent of every ``preserve`` axis (TP
        groups stay intact).  Non-preserved axes shrink outermost-first: an
        axis whose extent no longer divides the survivors collapses to 1
        and the innermost non-preserved axis absorbs the rest."""
        keep = 1
        for k, s in self.axes:
            if k in preserve:
                keep *= s
        if n_devices <= 0 or n_devices % keep:
            raise ValueError(
                f"survivors ({n_devices}) not divisible by preserved axes "
                f"{[(k, s) for k, s in self.axes if k in preserve]}")
        rest = n_devices // keep
        free = [k for k in self.axis_names if k not in preserve]
        if not free:
            if rest != 1:
                raise ValueError(f"all axes preserved but {rest} spare devices")
            return self
        sizes = dict(self.axes)
        new = dict(self.axes)
        for k in free[:-1]:
            new[k] = sizes[k] if rest % sizes[k] == 0 and sizes[k] <= rest else 1
            rest //= new[k]
        new[free[-1]] = rest
        return MeshSpec(axes=tuple((k, new[k]) for k in self.axis_names))


def mesh_spec(mesh) -> MeshSpec:
    """Normalize a mesh-like value into a :class:`MeshSpec`: a MeshSpec
    (pass-through), a live mesh (anything with a ``.shape`` name->size
    mapping), a dict, or an iterable of ``(name, size)`` pairs."""
    if isinstance(mesh, MeshSpec):
        return mesh
    shape = getattr(mesh, "shape", mesh)
    if hasattr(shape, "items"):
        return MeshSpec(axes=tuple((str(k), int(v)) for k, v in shape.items()))
    return MeshSpec(axes=tuple((str(k), int(v)) for k, v in shape))


@dataclasses.dataclass(frozen=True)
class ShardedSchedule:
    """One planned execution of one kernel across a device mesh.

    ``schedule`` is the per-device local Schedule (its blocks drive the
    local launch); ``partition`` records how every operand (and the output,
    last) splits over ``axis``; ``strategy`` names the multi-device
    dataflow the registry's sharded impl executes.
    """

    schedule: Schedule  # the per-device local schedule
    mesh: MeshSpec
    axis: str  # the partitioned mesh axis ("model", "data", ...)
    strategy: str  # "single" | "batch" | "stack" | "psum" | "ring" | "tp"
    partition: Partition
    hbm_loads: int  # shard-group-total main-memory words loaded
    hbm_stores: int  # shard-group-total main-memory words stored
    ici_words: int = 0  # shard-group-total interconnect words moved
    macs: int = 0  # shard-group-total multiply-accumulates

    @property
    def op(self) -> str:
        return self.schedule.op

    @property
    def algorithm(self) -> str:
        """The per-device schedule's algorithm family (batch/stack
        partitions apply to both conv families identically)."""
        return self.schedule.algorithm

    @property
    def devices(self) -> int:
        """Extent of the partitioned axis — the shard group every word
        total is summed over (not the whole mesh: orthogonal axes
        replicate this plan)."""
        if self.axis not in self.mesh.axis_names:
            return 1
        return self.mesh.axis_size(self.axis)

    @property
    def hbm_words(self) -> int:
        return self.hbm_loads + self.hbm_stores

    @property
    def modeled_words(self) -> int:
        """All modeled words, on- and off-mesh — the argmin quantity."""
        return self.hbm_words + self.ici_words

    def per_device(self, words: int) -> int:
        """Shard-group total -> per-device words."""
        return words // self.devices

    @property
    def traffic(self) -> ccr.Traffic:
        """HBM words as main-memory traffic, ICI words as inter-cluster
        traffic (the paper's on/off-chip split)."""
        return ccr.Traffic(macs=self.macs, main_loads=self.hbm_loads,
                           main_stores=self.hbm_stores, intercluster=self.ici_words)

    def fits(self, machine: MachineModel, streams: int = 2) -> bool:
        """Per-device working set vs the machine budget (Sec. 2.2.2)."""
        return self.schedule.fits(machine, streams)

    def block(self, name: str, default: int | None = None) -> int:
        return self.schedule.block(name, default)


def local_schedule(s) -> Schedule | None:
    """The per-device Schedule of either schedule flavor (``None`` passes
    through) — the unwrap every kernel wrapper and layer uses."""
    if s is None or isinstance(s, Schedule):
        return s
    if isinstance(s, ShardedSchedule):
        return s.schedule
    raise TypeError(f"expected Schedule or ShardedSchedule, got {type(s)!r}")


def partition_specs(sharded: ShardedSchedule) -> tuple[P, ...]:
    """A ShardedSchedule's partition as :class:`P` specs,
    ``(*operand_specs, out_spec)`` — the one place plan-layer partitions
    become the specs the sharded impls run."""
    return tuple(P(*entry) for entry in sharded.partition)


# Schedule-key stems per model family (the part before any ".dx"/".dw"
# backward suffix).  A plan set must come from ONE family's plan_training.
_FAMILY_STEMS: dict[str, tuple[str, ...]] = {
    "cnn": ("conv", "fc"),
    "transformer": ("qkv", "attn", "wo", "mlp_up", "mlp_down", "logits", "moe"),
}


def _stem_family(key: str) -> str | None:
    stem = key.split(".")[0]
    for fam, prefixes in _FAMILY_STEMS.items():
        if any(stem == p or (stem.startswith(p) and stem[len(p):].isdigit())
               for p in prefixes):
            return fam
    return None


def validate_sharded_plan(schedules: dict, mesh, machine: MachineModel | None = None) -> int:
    """Check a plan set (e.g. ``cnn.plan_training(mesh=...)``) is valid for
    ``mesh``: every entry is a ShardedSchedule planned against exactly
    this MeshSpec, its partitioned axis exists, its words are non-negative
    and (with ``machine``) its per-device working set fits; all keys belong
    to one model family's stage namespace.  Raises ValueError naming the
    offending stage; returns the number of schedules checked."""
    ms = mesh_spec(mesh)
    families = {f for f in map(_stem_family, schedules) if f is not None}
    if len(families) > 1:
        raise ValueError(
            f"mixed-family schedule keys {sorted(schedules)}: stages from "
            f"{sorted(families)} cannot share one plan set")
    for name, s in schedules.items():
        if not isinstance(s, ShardedSchedule):
            raise ValueError(
                f"{name}: expected a ShardedSchedule for mesh {ms.axes}, "
                f"got {type(s).__name__} (re-plan did not thread mesh=?)")
        if s.mesh != ms:
            raise ValueError(
                f"{name}: planned for mesh {s.mesh.axes}, not {ms.axes} — "
                "stale plan from before the re-mesh")
        if s.axis not in ms.axis_names:
            raise ValueError(f"{name}: partitioned axis {s.axis!r} not in mesh {ms.axes}")
        if min(s.hbm_loads, s.hbm_stores, s.ici_words) < 0:
            raise ValueError(f"{name}: negative modeled words")
        if machine is not None and not s.fits(machine):
            raise ValueError(
                f"{name}: per-device working set exceeds {machine.name} "
                f"local memory on mesh {ms.axes}")
    return len(schedules)


@dataclasses.dataclass(frozen=True)
class ShardCandidate:
    """One partitioning a planner considers: which strategy, how the local
    (per-device) shapes shrink, how operands split, and what the mesh pays
    in interconnect words.  ``hbm_override`` replaces the default
    ``devices * local_schedule`` accounting (the ring's reuse means its HBM
    words are not the local plan's words)."""

    strategy: str
    local_shape: dict
    partition: Partition
    ici_words: int = 0
    hbm_override: tuple[int, int] | None = None  # (loads, stores) totals
    macs_override: int | None = None
