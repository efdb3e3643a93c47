"""Mesh construction for the launcher and the tests.

Functions, never module-level meshes: importing this module forms no
process group.  A :class:`~repro_torch.runtime.collectives.Mesh` of more
than one device spans the ranks of the initialized process group, one rank
a device.
"""

from __future__ import annotations

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
