"""The mesh and its collectives over ``torch.distributed``: the port's
counterpart of ``jax.sharding.Mesh``, ``shard_map`` and ``jax.lax``'s
collectives, which the JAX package reaches through ``core/shard_compat.py``.

A :class:`Mesh` names the axes of the process group's ranks (row-major:
the last axis varies fastest, as a jax mesh lays out its devices) and holds
one process group per axis line.  Each rank is one process; the functions
below are *rank-local*: they take this rank's tensor and run the collective
over the ranks of one axis line.

* :func:`psum`, :func:`all_gather` and :func:`ppermute` are differentiable,
  with the backward ``jax.grad`` gives through a ``shard_map``: the psum of
  a value every rank then uses alike passes its cotangent through to each
  rank's term; the gather hands each rank its own slice of the cotangent;
  the permute sends the cotangent back along the inverse permutation.
  :func:`pmax` and :func:`int8 payloads <repro_torch.optim.compression.int8_psum>`
  are not differentiated.
* :func:`shard_map` runs a rank-local function on the global operands every
  rank holds: it slices each operand by its spec (:class:`~repro_torch.plan
  .sharded.P`), runs the function and gathers the output by its spec, so
  the caller sees the global result — and the global gradients — on every
  rank, as a caller of ``jax.shard_map`` does.

The backend is the process group's own (``nccl`` or ``gloo``, chosen where
the group is formed and never probed).  Every collective here is one of
``all_reduce``, ``all_gather`` and ``all_to_all_single``, which both
backends take on CUDA tensors (``gloo`` stages them through host memory
itself); the permute is an ``all_to_all_single``, not gloo's
point-to-point, which does not take CUDA tensors.  A collective that fails
raises; there is no other path.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import math
import time

import torch
import torch.distributed as dist

from repro_torch.plan.sharded import P

BACKENDS = ("nccl", "gloo")


@dataclasses.dataclass
class Stats:
    """Counters of this process's collectives: calls by kind, bytes each
    rank put on the wire, and the wall seconds spent in them.  With
    ``sync`` set (a measurement run), each collective first waits for the
    device's queued work, so its seconds hold the collective alone."""

    calls: dict = dataclasses.field(default_factory=dict)
    wire_bytes: int = 0
    seconds: float = 0.0
    sync: bool = False

    def reset(self, sync: bool = False) -> None:
        self.calls, self.wire_bytes, self.seconds, self.sync = {}, 0, 0.0, sync

    def as_dict(self) -> dict:
        return dict(calls=dict(self.calls), wire_bytes=self.wire_bytes,
                    seconds=self.seconds)


STATS = Stats()


class Mesh:
    """Named axes over the ranks of the default process group.

    ``shape`` is ``{axis: size}`` in axis order and ``axis_names`` the
    names, as on a jax mesh.  A mesh of one device needs no process group;
    a larger one needs an initialized group of exactly its size, and raises
    otherwise.  Every rank must build the same mesh at the same point
    (forming the axis groups is collective).
    """

    def __init__(self, shape, axis_names):
        shape, axis_names = tuple(int(s) for s in shape), tuple(axis_names)
        if len(shape) != len(axis_names) or len(set(axis_names)) != len(axis_names):
            raise ValueError(f"mesh shape {shape} does not match axes {axis_names}")
        self.dims = shape
        self.axis_names = axis_names
        self.size = math.prod(shape)
        if self.size > 1:
            if not dist.is_initialized():
                raise RuntimeError(f"a mesh of {self.size} devices needs an initialized "
                                   "process group (torch.distributed.init_process_group)")
            if dist.get_world_size() != self.size:
                raise ValueError(f"mesh {dict(self.shape)} needs {self.size} ranks, the "
                                 f"process group has {dist.get_world_size()}")
            self.rank = dist.get_rank()
            self.backend = str(dist.get_backend())
        else:
            self.rank, self.backend = 0, None
        self.coords = self._coords(self.rank)
        self._groups: dict[tuple[str, ...], object] = {}
        for a in axis_names:
            self.group((a,))

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.dims))

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank}, backend={self.backend})"

    def _coords(self, rank: int) -> dict:
        out = {}
        for name, n in reversed(list(zip(self.axis_names, self.dims))):
            out[name] = rank % n
            rank //= n
        return out

    def _rank_of(self, coords: dict) -> int:
        r = 0
        for name, n in zip(self.axis_names, self.dims):
            r = r * n + coords[name]
        return r

    def axes(self, axis) -> tuple[str, ...]:
        axes = (axis,) if isinstance(axis, str) else tuple(axis)
        for a in axes:
            if a not in self.axis_names:
                raise KeyError(f"mesh {self.shape} has no axis {a!r}")
        return axes

    def axis_size(self, axis) -> int:
        return math.prod(self.shape[a] for a in self.axes(axis))

    def axis_index(self, axis) -> int:
        """This rank's position along ``axis`` (a name, or a tuple of names
        read row-major, outermost first)."""
        i = 0
        for a in self.axes(axis):
            i = i * self.shape[a] + self.coords[a]
        return i

    def group(self, axis):
        """The process group of this rank's line along ``axis`` (``None``
        when the line holds one rank).  Formed on first use, by every rank
        at once: each line's ranks in row-major order along the axes."""
        axes = self.axes(axis)
        if axes in self._groups:
            return self._groups[axes]
        group = None
        if self.axis_size(axes) > 1:
            others = [a for a in self.axis_names if a not in axes]
            lines = []
            for fixed in itertools.product(*(range(self.shape[a]) for a in others)):
                base = dict(zip(others, fixed))
                lines.append([self._rank_of({**base, **dict(zip(axes, pos))})
                              for pos in itertools.product(
                                  *(range(self.shape[a]) for a in axes))])
            group, _ = dist.new_subgroups_by_enumeration(lines, backend=self.backend)
        self._groups[axes] = group
        return group


# -- the transport ------------------------------------------------------------------


def _to_wire(t: torch.Tensor) -> torch.Tensor:
    t = t.contiguous()
    STATS.wire_bytes += t.numel() * t.element_size()
    return t


@contextlib.contextmanager
def _timed(kind: str, t: torch.Tensor):
    STATS.calls[kind] = STATS.calls.get(kind, 0) + 1
    if STATS.sync and t.is_cuda:
        torch.cuda.synchronize(t.device)
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if STATS.sync and t.is_cuda:
            torch.cuda.synchronize(t.device)
        STATS.seconds += time.perf_counter() - t0


def _all_reduce(x: torch.Tensor, mesh: Mesh, axis, op) -> torch.Tensor:
    group = mesh.group(axis)
    if group is None:
        return x.clone()
    with _timed(f"all_reduce_{op}", x):
        buf = _to_wire(x).clone()
        dist.all_reduce(buf, op=getattr(dist.ReduceOp, op.upper()), group=group)
        return buf


def _all_gather(x: torch.Tensor, mesh: Mesh, axis, dim: int) -> torch.Tensor:
    group = mesh.group(axis)
    if group is None:
        return x.clone()
    with _timed("all_gather", x):
        wire = _to_wire(x)
        parts = [torch.empty_like(wire) for _ in range(mesh.axis_size(axis))]
        dist.all_gather(parts, wire, group=group)
        return torch.cat(parts, dim=dim)


class Pending:
    """An in-flight :func:`ppermute_start`; :meth:`wait` gives the tensor
    this rank received (zeros where no rank sends to it)."""

    def __init__(self, work, out, t0):
        self.work, self.out, self.t0 = work, out, t0

    def wait(self) -> torch.Tensor:
        if self.work is not None:
            self.work.wait()
            if STATS.sync and self.out.is_cuda:
                torch.cuda.synchronize(self.out.device)
            STATS.seconds += time.perf_counter() - self.t0
        return self.out


def ppermute_start(x: torch.Tensor, mesh: Mesh, axis, perm) -> Pending:
    """Start a permutation of ``x`` among the ranks of ``axis`` (``perm``:
    ``(source, destination)`` positions along the axis, as ``jax.lax
    .ppermute`` takes them) as one ``all_to_all_single`` whose only
    non-empty splits are this rank's destination and source, and return
    without waiting (the caller overlaps it with compute)."""
    n = mesh.axis_size(axis)
    me = mesh.axis_index(axis)
    perm = [(int(s) % n, int(d) % n) for s, d in perm]
    dst = [d for s, d in perm if s == me]
    src = [s for s, d in perm if d == me]
    if n == 1:
        return Pending(None, x.clone() if src else torch.zeros_like(x), 0.0)
    STATS.calls["ppermute"] = STATS.calls.get("ppermute", 0) + 1
    if STATS.sync and x.is_cuda:
        torch.cuda.synchronize(x.device)
    t0 = time.perf_counter()
    wire = _to_wire(x).reshape(-1)
    numel = wire.numel()
    send = [numel if j in dst else 0 for j in range(n)]
    recv = [numel if j in src else 0 for j in range(n)]
    out = torch.zeros(sum(recv), dtype=wire.dtype, device=wire.device)
    work = dist.all_to_all_single(out, wire if dst else wire[:0], recv, send,
                                  group=mesh.group(axis), async_op=True)
    if not src:
        out = torch.zeros_like(wire)
    return Pending(work, out.reshape(x.shape), t0)


def _ppermute(x, mesh, axis, perm):
    return ppermute_start(x, mesh, axis, perm).wait()


# -- the collectives ---------------------------------------------------------------


def axis_index(mesh: Mesh, axis) -> int:
    return mesh.axis_index(axis)


def axis_size(mesh: Mesh, axis) -> int:
    return mesh.axis_size(axis)


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return _all_reduce(x, mesh, axis, "sum")

    @staticmethod
    def backward(ctx, g):
        # The sum is used alike on every rank, so each rank's term gets the
        # cotangent as it is (jax: the transpose of psum into an invariant
        # value is the identity on each device).
        return g, None, None


def psum(x: torch.Tensor, mesh: Mesh, axis) -> torch.Tensor:
    """Sum ``x`` over the ranks of ``axis`` (every rank gets the sum)."""
    return _Psum.apply(x, mesh, axis)


def pmax(x: torch.Tensor, mesh: Mesh, axis) -> torch.Tensor:
    """Elementwise maximum over the ranks of ``axis`` (not differentiated)."""
    return _all_reduce(x.detach(), mesh, axis, "max")


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim, ctx.n = mesh, axis, dim, x.shape[dim]
        return _all_gather(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        i = ctx.mesh.axis_index(ctx.axis)
        return g.narrow(ctx.dim, i * ctx.n, ctx.n), None, None, None


def all_gather(x: torch.Tensor, mesh: Mesh, axis, dim: int = 0) -> torch.Tensor:
    """Concatenate the ranks' ``x`` along ``dim`` in axis order (``jax.lax
    .all_gather(..., tiled=True)``)."""
    return _AllGather.apply(x, mesh, axis, dim % x.ndim)


class _Ppermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, perm):
        ctx.mesh, ctx.axis, ctx.perm = mesh, axis, perm
        return _ppermute(x, mesh, axis, perm)

    @staticmethod
    def backward(ctx, g):
        inverse = [(d, s) for s, d in ctx.perm]
        return _ppermute(g, ctx.mesh, ctx.axis, inverse), None, None, None


def ppermute(x: torch.Tensor, mesh: Mesh, axis, perm) -> torch.Tensor:
    """Send ``x`` along ``perm`` (``(source, destination)`` positions on
    ``axis``); a rank no one sends to gets zeros, as ``jax.lax.ppermute``."""
    return _Ppermute.apply(x, mesh, axis, tuple((int(s), int(d)) for s, d in perm))


# -- shard_map: rank-local functions on global operands ---------------------------------


def _sharded_dim(spec, axis: str):
    """The dimension of ``spec`` that names ``axis`` (``None`` when the
    operand is replicated over it)."""
    dims = [d for d, e in enumerate(spec) if e == axis or (isinstance(e, tuple) and e == (axis,))]
    for e in spec:
        if e is not None and e != axis and e != (axis,):
            raise ValueError(f"spec {spec} names another axis than {axis!r}")
    if len(dims) > 1:
        raise ValueError(f"spec {spec} shards two dimensions over {axis!r}")
    return dims[0] if dims else None


class _Shard(torch.autograd.Function):
    """Global operand -> this rank's slice.  Backward: the global
    cotangent, the same on every rank — the ranks' slices gathered where
    the operand is split, their contributions summed where each rank used
    all of it."""

    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        if dim is None:
            return x.view_as(x)
        n = mesh.axis_size(axis)
        if x.shape[dim] % n:
            raise ValueError(f"dimension {dim} of {tuple(x.shape)} does not split over "
                             f"{n} ranks of {axis!r}")
        step = x.shape[dim] // n
        return x.narrow(dim, mesh.axis_index(axis) * step, step).contiguous()

    @staticmethod
    def backward(ctx, g):
        if ctx.dim is None:
            return _all_reduce(g, ctx.mesh, ctx.axis, "sum"), None, None, None
        return _all_gather(g, ctx.mesh, ctx.axis, ctx.dim), None, None, None


def shard(x: torch.Tensor, spec, mesh: Mesh, axis: str) -> torch.Tensor:
    """This rank's piece of the global ``x`` under ``spec`` over ``axis``."""
    return _Shard.apply(x, mesh, axis, _sharded_dim(spec, axis))


def unshard(y: torch.Tensor, spec, mesh: Mesh, axis: str) -> torch.Tensor:
    """The global value of this rank's ``y`` under ``spec``: gathered
    along the dimension that names ``axis``, else ``y`` itself (already
    the same on every rank)."""
    dim = _sharded_dim(spec, axis)
    return y if dim is None else all_gather(y, mesh, axis, dim)


def shard_map(fn, *, mesh: Mesh, in_specs, out_specs, axis: str):
    """``fn`` (rank-local, may run collectives over ``axis``) as a function
    of the global operands: each operand is cut to this rank's piece by its
    spec, the output gathered by ``out_specs``.  ``None`` operands pass
    through.  Mesh axes other than ``axis`` replicate the computation."""

    def run(*args):
        local = [a if a is None else shard(a, s, mesh, axis)
                 for a, s in zip(args, in_specs, strict=True)]
        return unshard(fn(*local), out_specs, mesh, axis)

    return run


__all__ = [
    "BACKENDS", "Mesh", "P", "STATS", "Stats", "all_gather", "axis_index", "axis_size",
    "pmax", "ppermute", "ppermute_start", "psum", "shard", "shard_map", "unshard",
]
