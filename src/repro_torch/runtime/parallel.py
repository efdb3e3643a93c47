"""Parallelism context and the divisibility-aware sharding policy, as in
the JAX package's ``runtime/parallel.py``.

The production mesh is ``(data=16, model=16)`` single-pod and ``(pod=2,
data=16, model=16)`` multi-pod.  Within it the policy adapts per shape:

  * batch dims shard over as many of (pod, data) as divide the batch;
  * the TP axis ('model') lands on the first divisible candidate dim
    (kv-heads, then head_dim, then sequence for KV caches);
  * when the batch cannot use the data axes (batch 1), the KV/state
    sequence or head dims take them instead so no axis idles.

The spec functions are pure functions of the mesh's shape and return
:class:`~repro_torch.plan.sharded.P`.  The JAX package's ``constrain`` (a
GSPMD sharding hint) and ``ParallelCtx.sharded_shardings`` (``NamedSharding``
objects) have no counterpart here: rank-local tensors carry no sharding to
hint, and the sharded impls read their specs off the ShardedSchedule.
"""

from __future__ import annotations

import dataclasses

from repro_torch.plan.sharded import P, mesh_spec


@dataclasses.dataclass(frozen=True)
class ParallelCtx:
    mesh: object  # a runtime.collectives.Mesh, or anything with .shape/.axis_names
    dp_axes: tuple[str, ...] = ("data",)
    tp_axis: str = "model"

    def plan_mesh(self):
        """This context's mesh as a hashable MeshSpec — the handle the
        mesh-aware planners take, so launchers and the runtime resolve
        ShardedSchedules from the same mesh they execute on."""
        return mesh_spec(self.mesh)

    @property
    def dp_size(self) -> int:
        n = 1
        for a in self.dp_axes:
            n *= self.mesh.shape[a]
        return n

    @property
    def tp_size(self) -> int:
        return self.mesh.shape[self.tp_axis]

    def batch_axes(self, batch: int) -> tuple[str, ...]:
        """Largest prefix-product of dp axes dividing ``batch`` (dp_axes
        ordered outermost-first, ('pod', 'data'))."""
        axes: tuple[str, ...] = ()
        n = 1
        for a in self.dp_axes:
            if batch % (n * self.mesh.shape[a]) == 0:
                axes += (a,)
                n *= self.mesh.shape[a]
        return axes

    def spare_dp_axes(self, batch: int) -> tuple[str, ...]:
        used = self.batch_axes(batch)
        return tuple(a for a in self.dp_axes if a not in used)


def data_axis(ctx: ParallelCtx) -> str:
    """The one data axis a data-parallel step shards its batch over: the
    dp axis with more than one device (the last dp axis when none has).
    A batch over two dp axes at once (a multi-pod mesh) waits for ROADMAP
    queue 1 #5b and raises."""
    used = [a for a in ctx.dp_axes if ctx.mesh.shape[a] > 1]
    if len(used) > 1:
        raise NotImplementedError(
            f"a batch sharded over the dp axes {tuple(used)} at once waits for "
            "ROADMAP queue 1 #5b; the data-parallel step takes one data axis")
    return used[0] if used else ctx.dp_axes[-1]


def first_divisible(size_by_candidate: list[tuple[int, int]], axis_size: int) -> int:
    """Index of the first (dim_index, dim_size) whose size divides; -1 if none."""
    for i, (_, n) in enumerate(size_by_candidate):
        if n % axis_size == 0 and n >= axis_size:
            return i
    return -1


def _lead(axes: tuple[str, ...]):
    return axes if len(axes) > 1 else (axes[0] if axes else None)


def kv_cache_spec(ctx: ParallelCtx, cache_shape: tuple, batch_dim: int = 1,
                  seq_dim: int = 2, head_dim: int = 3, dh_dim: int = 4) -> P:
    """Spec for a [L, B, S, H, Dh]-like cache tensor."""
    entries: list = [None] * len(cache_shape)
    B = cache_shape[batch_dim]
    baxes = ctx.batch_axes(B)
    if baxes:
        entries[batch_dim] = _lead(baxes)
    # TP axis: kv heads > head_dim > sequence.
    cands = [(head_dim, cache_shape[head_dim]), (dh_dim, cache_shape[dh_dim]),
             (seq_dim, cache_shape[seq_dim])]
    pick = first_divisible(cands, ctx.tp_size)
    if pick >= 0:
        entries[cands[pick][0]] = ctx.tp_axis
    # Idle dp axes (batch too small): spread the sequence.
    spare = ctx.spare_dp_axes(B)
    if spare and entries[seq_dim] is None:
        n = 1
        for a in spare:
            n *= ctx.mesh.shape[a]
        if cache_shape[seq_dim] % n == 0:
            entries[seq_dim] = _lead(spare)
    return P(*entries)


def state_spec(ctx: ParallelCtx, shape: tuple, batch_dim: int = 1) -> P:
    """Spec for recurrent state tensors [L, B, ...]: batch over dp, first
    divisible trailing dim over model."""
    entries: list = [None] * len(shape)
    baxes = ctx.batch_axes(shape[batch_dim])
    if baxes:
        entries[batch_dim] = _lead(baxes)
    cands = [(i, shape[i]) for i in range(batch_dim + 1, len(shape))]
    pick = first_divisible(cands, ctx.tp_size)
    if pick >= 0:
        entries[cands[pick][0]] = ctx.tp_axis
    return P(*entries)


def cache_specs(ctx: ParallelCtx, cache_tree) -> dict:
    """Specs for a family's cache (a dict of tensors, or of dicts) by shape
    pattern: a 5-dim leaf whose dim 2 is at least its dim 3 is a KV cache,
    any other leaf a recurrent state."""

    def one(leaf):
        shp = tuple(leaf.shape)
        if len(shp) == 5 and shp[2] >= shp[3]:
            return kv_cache_spec(ctx, shp)
        return state_spec(ctx, shp)

    def walk(tree):
        if isinstance(tree, dict):
            return {k: walk(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(walk(v) for v in tree)
        return one(tree)

    return walk(cache_tree)


def batch_spec(ctx: ParallelCtx, batch: int, ndim: int = 2) -> P:
    return P(_lead(ctx.batch_axes(batch)), *([None] * (ndim - 1)))
