"""Mesh construction for the launcher and the tests, and the elastic
run's process group.

Functions, never module-level meshes: importing this module forms no
process group.  A :class:`~repro_torch.runtime.collectives.Mesh` of more
than one device spans the ranks of the initialized process group, one rank
a device.  :class:`ElasticGroup` re-forms that group over the survivors
when hosts leave.
"""

from __future__ import annotations

import datetime

import torch.distributed as dist

from repro_torch.plan.sharded import MeshSpec
from repro_torch.runtime.collectives import Mesh
from repro_torch.runtime.parallel import ParallelCtx


def _production_shape(multi_pod: bool):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return shape, axes


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The production mesh over the process group's ranks: 256 (or 512)
    ranks; any other count raises."""
    shape, axes = _production_shape(multi_pod)
    n = dist.get_world_size() if dist.is_initialized() else 1
    want = 1
    for s in shape:
        want *= s
    if n != want:
        raise ValueError(f"the production mesh {dict(zip(axes, shape))} needs {want} "
                         f"ranks, the process group has {n}")
    return Mesh(shape, axes)


def make_ctx(mesh=None, *, multi_pod: bool = False) -> ParallelCtx:
    mesh = mesh if mesh is not None else make_production_mesh(multi_pod=multi_pod)
    dp = ("pod", "data") if "pod" in mesh.axis_names else ("data",)
    return ParallelCtx(mesh=mesh, dp_axes=dp, tp_axis="model")


def make_test_mesh(shape=(2, 4), axes=("data", "model")) -> Mesh:
    """A small mesh over the process group's ranks (tests)."""
    return Mesh(shape, axes)


def production_mesh_spec(*, multi_pod: bool = False) -> MeshSpec:
    """The production mesh as a MeshSpec — lets the mesh-aware planners
    model the 16x16 (or 2x16x16) partitioning without a process group."""
    shape, axes = _production_shape(multi_pod)
    return MeshSpec(axes=tuple(zip(axes, shape)))


class ElasticGroup:
    """The ranks of an elastic run: the process group it started in, and
    the group it re-forms over the survivors after each host failure.

    The ranks of a host are ``devices_per_host`` consecutive ranks (the
    mesh's model extent, so a tensor-parallel group never spans hosts);
    rank ``r`` lives on ``host{r // devices_per_host}``.  On a shrink to
    ``n`` devices the ranks of the failed hosts leave (when the failure
    named hosts that account for them; else the highest-numbered ranks,
    which are the hosts the chaos monkey kills: a failure that names no
    host of the mesh), and the survivors tear the
    old group down and form a new one of ``n`` ranks, renumbered in order,
    over a ``PrefixStore`` of the first group's store keyed by the
    incarnation (a store is not safe to reuse across
    ``destroy_process_group`` otherwise; the prefix works for a ``file://``
    store and for ``torchrun``'s).  Every group it forms has ``timeout``,
    so a collective that a rank never joins fails the rest instead of
    hanging them."""

    def __init__(self, devices_per_host: int, timeout: float):
        from torch.distributed import distributed_c10d

        self.store = distributed_c10d._get_default_store()
        self.backend = str(dist.get_backend())
        self.rank, self.world = dist.get_rank(), dist.get_world_size()
        self.devices_per_host = devices_per_host
        self.timeout = datetime.timedelta(seconds=timeout)
        self.incarnation = 0
        self.dead: list[str] = []  # the hosts of the last failure
        self.failed_at: int | None = None

    def host(self, rank: int | None = None) -> str:
        return f"host{(self.rank if rank is None else rank) // self.devices_per_host}"

    def on_failure(self, step: int, failure) -> None:
        """``ElasticRun.on_failure``: remember who failed, and when."""
        self.dead, self.failed_at = list(failure.dead), step

    def leaving(self, n: int) -> list[int]:
        """The ranks that leave on a shrink to ``n`` devices."""
        named = [r for r in range(self.world) if self.host(r) in self.dead]
        return named if len(named) == self.world - n else list(range(n, self.world))

    def shrink(self, n: int) -> bool:
        """Re-form the group over ``n`` survivors (a count at or above the
        current world keeps the group).  Returns False in a rank that
        left: its group is torn down and it takes no further part."""
        if n >= self.world:
            return True
        gone = self.leaving(n)
        stay = [r for r in range(self.world) if r not in gone]
        dist.destroy_process_group()
        if self.rank in gone:
            return False
        self.incarnation += 1
        self.rank, self.world = stay.index(self.rank), n
        dist.init_process_group(
            self.backend, store=dist.PrefixStore(f"elastic{self.incarnation}/", self.store),
            rank=self.rank, world_size=n, timeout=self.timeout)
        return True

    def barrier(self) -> None:
        if self.world > 1:
            dist.barrier()
