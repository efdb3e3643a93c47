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

What GSPMD does for the JAX package from those hints, the port does by
hand: :func:`shard_tensor`/:func:`gather_tensor` cut a global tensor to
this rank's piece under a ``P`` and put it back together, and the
tensor-parallel ops (Megatron's two conjugate operators and a slice) let a
model run its heads and d_ff split over the model axis:

* :func:`tp_enter` — identity forward, psum over ``model`` backward: where
  a replicated activation enters a column-parallel region;
* :func:`tp_exit` — psum over ``model`` forward, identity backward: where
  a row-parallel region's partial sums leave it;
* :func:`tp_slice` / :func:`tp_take` — a slice (or ranges) of a tensor
  every model rank holds whole, whose gradient is put back in place and
  summed over ``model``;
* :func:`tp_reduce` — psum over ``model`` both ways: where each rank uses
  a sum of partials in its own way (a norm over a split dimension);
* :func:`tp_whole` — a tensor the model axis splits, gathered whole for
  every rank to use alike.
"""

from __future__ import annotations

import dataclasses

import torch

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
    """The data axis a plan shards its batch over (the planners take one
    axis): the innermost dp axis with more than one device, else the last
    dp axis.  On a mesh whose batch spans two dp axes the plan of the
    global batch over this axis, at the batch times its extent, has the
    local shapes of the batch over both."""
    used = [a for a in ctx.dp_axes if ctx.mesh.shape[a] > 1]
    return used[-1] if used else ctx.dp_axes[-1]


def spec_axes(entry) -> tuple[str, ...]:
    """The mesh axes one spec entry names (outermost first)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _entries(spec, ndim: int) -> list:
    return list(spec) + [None] * (ndim - len(spec))


def local_index(shape, spec, mesh) -> tuple[slice, ...]:
    """This rank's piece of a ``shape`` tensor under ``spec`` as one slice
    per dimension."""
    out = []
    for n, e in zip(shape, _entries(spec, len(shape))):
        names = spec_axes(e)
        k = mesh.axis_size(names) if names else 1
        i = mesh.axis_index(names) if names else 0
        out.append(slice(i * (n // k), (i + 1) * (n // k)))
    return tuple(out)


def shard_tensor(x: torch.Tensor, spec, mesh, axes=None) -> torch.Tensor:
    """This rank's piece of the global ``x`` under ``spec``: each dimension
    cut by the axes its entry names (those in ``axes`` only, when given),
    as a contiguous copy."""
    for dim, e in enumerate(_entries(spec, x.ndim)):
        names = tuple(a for a in spec_axes(e) if axes is None or a in axes)
        if not names:
            continue
        n = mesh.axis_size(names)
        if x.shape[dim] % n:
            raise ValueError(f"dimension {dim} of {tuple(x.shape)} does not split over "
                             f"{n} ranks of {names}")
        step = x.shape[dim] // n
        x = x.narrow(dim, mesh.axis_index(names) * step, step)
    return x.contiguous()


def gather_tensor(x: torch.Tensor, spec, mesh, axes=None, *,
                  grad: bool = False) -> torch.Tensor:
    """The global tensor of this rank's piece ``x`` under ``spec`` (only
    the dimensions whose entries name ``axes``, when given, are put back).
    With ``grad`` the gather is differentiable, its backward the
    reduce-scatter (:func:`~repro_torch.runtime.collectives.gather_shards`)."""
    from repro_torch.runtime import collectives as coll

    for dim, e in enumerate(_entries(spec, x.ndim)):
        names = tuple(a for a in spec_axes(e) if axes is None or a in axes)
        if not names or mesh.axis_size(names) == 1:
            continue
        if grad:
            x = coll.gather_shards(x, mesh, names, dim)
        else:
            x = coll._all_gather(x, mesh, names, dim)
    return x


def fit_spec(spec, shape, mesh):
    """``spec`` for a ``shape`` leaf on ``mesh``: an entry whose axes do not
    divide its dimension is dropped, and the leaf is held whole over them
    (the specs are chosen at the production model axis of 16; on a model
    axis of 3 a vocab of 151936 does not split, and the layers then take
    such a leaf whole, ``models/layers.py``)."""
    entries = _entries(spec, len(shape))
    return P(*(e if not spec_axes(e) or n % mesh.axis_size(spec_axes(e)) == 0 else None
               for e, n in zip(entries, shape)))


def replication(spec, mesh) -> int:
    """How many ranks hold each piece of a tensor under ``spec``: the
    extent of the mesh axes the spec does not name."""
    named = {a for e in spec for a in spec_axes(e)}
    n = 1
    for a, k in mesh.shape.items():
        if a not in named:
            n *= k
    return n


# -- tensor parallelism over the model axis ----------------------------------------


def tp_size(ctx: ParallelCtx | None) -> int:
    """The model axis's extent (1 without a context or a model axis)."""
    if ctx is None or ctx.tp_axis not in ctx.mesh.shape:
        return 1
    return ctx.tp_size


def tp_rank(ctx: ParallelCtx) -> int:
    return ctx.mesh.axis_index(ctx.tp_axis)


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, pctx):
        ctx.pctx = pctx
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        from repro_torch.runtime import collectives as coll

        p = ctx.pctx
        return coll._all_reduce(g, p.mesh, p.tp_axis, "sum"), None


def tp_enter(x: torch.Tensor, ctx: ParallelCtx) -> torch.Tensor:
    """Identity forward; the gradient is summed over the model axis (each
    model rank's column-parallel GEMMs gave a part of it)."""
    return x if tp_size(ctx) == 1 else _Enter.apply(x, ctx)


def tp_exit(x: torch.Tensor, ctx: ParallelCtx) -> torch.Tensor:
    """The psum over the model axis of a row-parallel GEMM's partial sums;
    the gradient passes through to every rank's term."""
    from repro_torch.runtime import collectives as coll

    return x if tp_size(ctx) == 1 else coll.psum(x, ctx.mesh, ctx.tp_axis)


class _Take(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, ranges, pctx):
        ctx.meta = (x.shape, dim, ranges, pctx)
        parts = [x.narrow(dim, start, length) for start, length in ranges]
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, g):
        from repro_torch.runtime import collectives as coll

        shape, dim, ranges, p = ctx.meta
        full = g.new_zeros(shape)
        off = 0
        for start, length in ranges:
            full.narrow(dim, start, length).add_(g.narrow(dim, off, length))
            off += length
        return coll._all_reduce(full, p.mesh, p.tp_axis, "sum"), None, None, None


def tp_take(x: torch.Tensor, dim: int, ranges, ctx: ParallelCtx) -> torch.Tensor:
    """The ``(start, length)`` ranges of ``dim`` of a tensor every model rank
    holds whole, concatenated in order; each rank's gradient is put back in
    place and summed over the model axis, so every rank gets the whole
    tensor's gradient (what a rank takes that others take too, such as
    Mamba-2's one B/C group, sums their parts)."""
    return _Take.apply(x, dim % x.ndim, tuple((int(s), int(n)) for s, n in ranges), ctx)


def tp_slice(x: torch.Tensor, dim: int, start: int, length: int,
             ctx: ParallelCtx) -> torch.Tensor:
    """``x.narrow(dim, start, length)`` of a tensor every model rank holds
    whole; each rank's gradient is put in place and summed over the model
    axis, so every rank gets the whole tensor's gradient (a slice that is
    the whole tensor, such as a KV head every rank reads, is
    :func:`tp_enter`)."""
    if start == 0 and length == x.shape[dim]:
        return tp_enter(x, ctx)
    return tp_take(x, dim, [(start, length)], ctx)


def tp_reduce(x: torch.Tensor, ctx: ParallelCtx) -> torch.Tensor:
    """The psum over the model axis of each rank's partial ``x`` where each
    rank then uses the sum in its own way (a norm over a dimension the
    model axis splits): the cotangent is summed over the model axis too."""
    return tp_enter(tp_exit(x, ctx), ctx)


def tp_whole(x: torch.Tensor, dim: int, n: int, ctx: ParallelCtx) -> torch.Tensor:
    """``x`` with its ``dim`` of global size ``n`` put back whole where the
    model axis splits it (every rank then uses it alike: the gradient of
    this rank's piece is its slice of the whole one)."""
    from repro_torch.runtime import collectives as coll

    if x.shape[dim] == n:
        return x
    return coll.all_gather(x, ctx.mesh, ctx.tp_axis, dim)


def tp_local(x: torch.Tensor, dim: int, n: int, ctx: ParallelCtx) -> torch.Tensor:
    """This model rank's even share of a dimension of global size ``n``:
    ``x`` itself where its storage already holds the share (the spec
    names the model axis), else :func:`tp_slice` of the whole."""
    tp = tp_size(ctx)
    if x.shape[dim] == n // tp:
        return x
    return tp_slice(x, dim, tp_rank(ctx) * (n // tp), n // tp, ctx)


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


@dataclasses.dataclass(frozen=True)
class SeqSplit:
    """A KV cache whose sequence is spread over ``axes`` of ``mesh`` (the
    data axes a small batch leaves idle, :func:`kv_cache_spec`'s "Idle dp
    axes" branch): each rank holds a contiguous run of the positions, the
    ranks in row-major order along ``axes``."""

    mesh: object
    axes: tuple[str, ...]

    @property
    def n(self) -> int:
        return self.mesh.axis_size(self.axes)

    @property
    def index(self) -> int:
        return self.mesh.axis_index(self.axes)

    def start(self, length: int) -> int:
        """This rank's first position, for a piece of ``length`` positions."""
        return self.index * length


def batch_spec(ctx: ParallelCtx, batch: int, ndim: int = 2) -> P:
    return P(_lead(ctx.batch_axes(batch)), *([None] * (ndim - 1)))
