"""The mesh types the planners import, for a single device.

A planner may be handed a :class:`MeshSpec`; over a one-device shard group
it degenerates to the meshless :class:`~repro_torch.plan.schedule.Schedule`
inside a :class:`ShardedSchedule` wrapper, as in the JAX package.  Planning
over more than one device (the batch/stack/psum/ring partitions) is not
ported yet.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.machine import MachineModel
from repro_torch.plan.schedule import Schedule

# Per-operand partition entries: one tuple per operand (outputs last), one
# entry per array dimension — ``None`` (replicated) or the mesh axis name.
Partition = tuple[tuple[str | None, ...], ...]


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Hashable description of a device mesh (names and sizes only)."""

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


@dataclasses.dataclass(frozen=True)
class ShardedSchedule:
    """One planned execution of one kernel across a device mesh:
    ``schedule`` is the per-device local Schedule, ``partition`` how every
    operand (the output last) splits over ``axis``."""

    schedule: Schedule
    mesh: MeshSpec
    axis: str
    strategy: str
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
        return self.schedule.algorithm

    @property
    def modeled_words(self) -> int:
        return self.hbm_loads + self.hbm_stores + self.ici_words

    def fits(self, machine: MachineModel, streams: int = 2) -> bool:
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

