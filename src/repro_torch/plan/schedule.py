"""`Schedule`: the single value every CUDA kernel of the port runs from.

The paper's contribution is a *capacity argument* — pick the output stack
Delta_O (and strip height) that maximizes reuse subject to on-cluster
memory.  A `Schedule` is one concrete outcome of that argument: the grid,
the block shapes, and the *model* behind the choice (main-memory words,
local working set).  On the H100 its blocks are a kernel's thread-block
tile and its ``vmem_bytes`` the shared memory that block allocates.

Schedules are frozen and hashable, so plans can be cached per shape.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.machine import MachineModel

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

    @property
    def modeled_words(self) -> int:
        """Modeled main-memory words moved (the quantity planners minimize)."""
        return self.loads + self.stores

    def fits(self, machine: MachineModel, streams: int = 2) -> bool:
        """Does the modeled working set fit the machine's local memory after
        the DMA-stream reservation (the paper's Sec. 2.2.2 rule)?"""
        return self.vmem_bytes <= machine.usable_for_working_set(streams)
