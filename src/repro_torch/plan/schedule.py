"""`Schedule`: the single value every CUDA kernel of the port runs from.

The paper's contribution is a *capacity argument* — pick the output stack
Delta_O (and strip height) that maximizes reuse subject to on-cluster
memory.  A `Schedule` is one concrete outcome of that argument: the grid,
the block shapes, and the *model* behind the choice (main-memory words,
local working set).  On the H100 its blocks are a kernel's thread-block
tile and its ``vmem_bytes`` the shared memory that block allocates.  The
same object states its traffic in the paper's accounting (core/ccr.py) and
lowers into the roofline of analysis/roofline.py (:func:`to_roofline`).

Schedules are frozen and hashable, so plans can be cached per shape.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core import ccr
from repro_torch.core.machine import H100, MachineModel, machine_named, word_bytes

# Block shapes as a sorted tuple of (name, size) pairs — hashable.
Blocks = tuple[tuple[str, int], ...]


@dataclasses.dataclass(frozen=True)
class Schedule:
    """One planned execution of one kernel on one machine."""

    op: str  # registry name of the kernel this schedule drives
    grid: tuple[int, ...]  # the kernel's grid of tiles
    blocks: Blocks  # block shapes by name, e.g. (("block_do", 64), ...)
    halo: int = 0  # input rows re-read between adjacent spatial tiles
    macs: int = 0  # modeled multiply-accumulates of the whole call
    loads: int = 0  # modeled main-memory words loaded
    stores: int = 0  # modeled main-memory words stored
    vmem_bytes: int = 0  # modeled working set incl. double-buffered streams
    machine: str = "h100"  # name of the MachineModel planned against
    algorithm: str = "direct"  # which algorithm family the blocks belong to
    critical_path_steps: int = 0  # sequential grid steps incl. pipeline fill

    def block(self, name: str, default: int | None = None) -> int:
        for k, v in self.blocks:
            if k == name:
                return v
        if default is None:
            raise KeyError(f"schedule for {self.op!r} has no block {name!r}")
        return default

    def block_dict(self) -> dict[str, int]:
        return dict(self.blocks)

    def evolve(self, **block_updates: int) -> "Schedule":
        """Copy with some block sizes replaced (model fields unchanged —
        re-plan through the op's Planner to refresh them)."""
        merged = {**dict(self.blocks), **block_updates}
        return dataclasses.replace(self, blocks=tuple(sorted(merged.items())))

    @property
    def modeled_words(self) -> int:
        """Modeled main-memory words moved (the quantity planners minimize)."""
        return self.loads + self.stores

    @property
    def traffic(self) -> ccr.Traffic:
        """This schedule's traffic in the paper's accounting framework."""
        return ccr.Traffic(macs=self.macs, main_loads=self.loads,
                           main_stores=self.stores)

    def fits(self, machine: MachineModel, streams: int = 2) -> bool:
        """Does the modeled working set fit the machine's local memory after
        the DMA-stream reservation (the paper's Sec. 2.2.2 rule)?"""
        return self.vmem_bytes <= machine.usable_for_working_set(streams)

    def bound_kind(self, machine: MachineModel, precision: str = "sp") -> str:
        """compute- vs memory-bound under this machine's balance point."""
        return ccr.bound_kind(self.traffic, machine, precision)

    def arithmetic_intensity(self, precision: str = "sp") -> float:
        """flop/B against main memory (2 flops per MAC)."""
        return self.traffic.flops_per_byte(precision, offchip_only=True)


def to_roofline(schedule: Schedule, *, precision: str = "sp", chips: int = 1,
                machine: MachineModel | None = None):
    """Lower a Schedule into analysis.roofline.Roofline: its modeled words
    become ``bytes_hbm``, its MACs both ``flops`` and ``model_flops`` (a
    kernel does no dispatch overhead), and a single-chip kernel moves no
    collective bytes.  The time terms take their peaks from ``machine``
    (default: the machine the schedule was planned against)."""
    from repro_torch.analysis.roofline import Roofline

    flops = 2.0 * schedule.macs
    return Roofline(
        flops=flops,
        bytes_hbm=float(schedule.modeled_words * word_bytes(precision)),
        bytes_coll=0.0,
        chips=chips,
        model_flops=flops,
        machine=machine or machine_named(schedule.machine, H100),
    )
