"""The paper's fully-connected layer (Algs 4/5) as a differentiable module.

Forward: the blocked matmul kernel with the output stack block_n (Alg 5's
Delta_O) and the K loop's accumulator (Alg 4's private partial output);
blocks from the MatmulPlanner unless an explicit ``schedule`` is given.
Across ranks the partitioning is a planner output: :func:`fc_layer_sharded`
resolves a :class:`~repro_torch.plan.ShardedSchedule` through the
``matmul`` op and the registry's sharded dispatch executes it ("psum":
input depth sharded, the private partial outputs combined by Alg 4's tree
reduction as one psum; "ring": Alg 3's neighbour-permute reuse,
core/ring.py; "batch" and "tp"; the planner picks by modeled HBM + ICI
words unless ``strategy=`` pins one).

Backward is planned too: autograd runs the ``matmul_dx`` kernel (dX = dY @
W^T, no W^T in device memory) and the ``matmul_dw`` kernel (dW = X^T @ dY),
or — when the dX schedule carries the ``fused_dxdw`` tag — the fused kernel
that computes both from one read of each dY tile (at the H100 pick, up to a
batch of 192, with both accumulators in registers and each k-block's
n-blocks split over enough thread blocks to fill the card).  Pin them with
``bwd_schedules={"dx": ..., "dw": ...}`` (see :func:`plan_bwd`).  An unfit
pinned schedule raises on the card; on CPU tensors it warns once and runs
the kernels' plain versions with its blocks.  :func:`traffic` gives the
paper's closed-form traffic of Alg 4 or 5 on a machine (Manticore by
default).
"""

from __future__ import annotations

from repro_torch.core import ccr
from repro_torch.core.conv_layer import admit_schedule
from repro_torch.core.machine import H100, MANTICORE
from repro_torch.kernels.matmul.bwd import matmul_dw, matmul_dx, matmul_dx_dw
from repro_torch.kernels.matmul.ops import fc_matmul
from repro_torch.plan import Schedule, ShardedSchedule, get_op, local_schedule
from repro_torch.plan.registry import with_reference_vjp

# The machine backward schedules are planned (and fit-checked) against.
_BWD_MACHINE = H100


def _fc_kernel(x, w, schedule, bwd_schedules):
    del bwd_schedules  # consumed by the backward pass
    return fc_matmul(x, w, schedule=schedule)


def _fc_bwd(x, w, g, schedule, bwd_schedules, *, needs):
    del schedule
    sd = dict(bwd_schedules or ())
    # dY keeps its dtype (bf16 on the bf16 route, planned at two bytes an
    # element); the kernels write f32 dX and dW, cast to x's and w's dtypes.
    s_dx = local_schedule(sd.get("dx")) or get_op("matmul_dx").plan(g, w)
    s_dw = local_schedule(sd.get("dw")) or get_op("matmul_dw").plan(x, g)
    admit_schedule("dx", s_dx, x.is_cuda)
    admit_schedule("dw", s_dw, x.is_cuda)
    if s_dx.algorithm == "fused_dxdw":
        # One kernel, one dY stream for both gradients: the fused schedule
        # carries the whole-M dX strip, so the gate above covered it.
        dx, dw = matmul_dx_dw(g, w, x, schedule=s_dx)
        return (dx.to(x.dtype) if needs[0] else None), dw.to(w.dtype)
    dx = matmul_dx(g, w, schedule=s_dx).to(x.dtype) if needs[0] else None
    dw = matmul_dw(x, g, schedule=s_dw).to(w.dtype)
    return dx, dw


_fc_layer_vjp = with_reference_vjp(_fc_kernel, nondiff_argnums=(2, 3),
                                   bwd_fn=_fc_bwd)


def fc_layer(x, w, schedule: Schedule | ShardedSchedule | None = None,
             bwd_schedules=None):
    """x: [..., K]; w: [K, D_O].  Forward = the Alg 4/5 kernel (its plain
    version on CPU tensors).  ``bwd_schedules`` ({"dx"/"dw": Schedule})
    pins the planned backward kernels' blocking (see :func:`plan_bwd`)."""
    return _fc_layer_vjp(x, w, local_schedule(schedule), bwd_schedules)


def _fc_m(x_shape) -> int:
    m = 1
    for d in x_shape[:-1]:
        m *= d
    return m


def plan(x_shape, w_shape, *, in_bytes=4, machine=None, mesh=None, shard_axis="model",
         strategy=None, autotune=None):
    """Plan this layer without running it: the Schedule the kernel would
    use for operands of these shapes.  With ``mesh=`` the returned
    ShardedSchedule also carries the device partitioning over
    ``shard_axis`` (pinned by ``strategy=``) and the HBM/ICI word split.
    ``autotune`` ("off" | "cache-only" | "tune", default the process
    policy) lets a measured winner for this cell override the modeled
    argmin."""
    from repro_torch.plan import autotune as at

    k, n = w_shape
    return at.resolve("matmul", dict(m=_fc_m(x_shape), n=n, k=k, in_bytes=in_bytes),
                      machine=machine or H100, mesh=mesh, axis=shard_axis,
                      strategy=strategy, policy=autotune)


def plan_bwd(x_shape, w_shape, *, in_bytes=4, machine=None, mesh=None, shard_axis="data",
             autotune=None) -> dict:
    """Backward-pass Schedules for this layer's shapes: the dX and dW
    kernels autograd will run.  The "dx" cell prefers the fused dX/dW
    kernel (``algorithm="fused_dxdw"``: ``_fc_bwd`` dispatches on the tag
    and the "dw" schedule goes unused) and falls back to the direct pair
    when the fused whole-M dX strip overflows the machine.  With ``mesh=``
    both come back as ShardedSchedules (dX shards with the batch; dW also
    charges the Alg-4 tree reduction of the weight gradient as
    ici_words).  Both cells honor the ``autotune=`` policy like the
    forward."""
    from repro_torch.plan import autotune as at

    machine = machine or _BWD_MACHINE
    k, n = w_shape
    shape = dict(m=_fc_m(x_shape), n=n, k=k, in_bytes=in_bytes)

    def res(op, **extra):
        return at.resolve(op, dict(shape, **extra), machine=machine, mesh=mesh,
                          axis=shard_axis, policy=autotune)

    dx = res("matmul_dx", algorithm="fused_dxdw")
    if not dx.fits(machine):
        dx = res("matmul_dx")
    return {"dx": dx, "dw": res("matmul_dw")}


def fc_layer_sharded(x, w, mesh, axis: str = "model",
                     schedule: ShardedSchedule | None = None,
                     strategy: str | None = "psum", machine=None, autotune=None):
    """The FC layer across a mesh axis, partitioned by the planner.

    Every rank passes the global x [M, K] and w [K, N] and gets the global
    [M, N] (and, under autograd, the global gradients).  The default pins
    the paper's Alg 4 ("psum": K sharded, one psum of private partial
    outputs); ``strategy=None`` lets the mesh-aware MatmulPlanner choose
    by modeled HBM + ICI words; an explicit ``schedule`` (from :func:`plan`
    with ``mesh=``) overrides planning.  Execution goes through the
    ``matmul`` op's sharded impl, which reads the specs off
    ``schedule.partition``."""
    op = get_op("matmul")
    if schedule is None:
        schedule = op.plan_sharded(x, w, mesh=mesh, axis=axis, strategy=strategy,
                                   machine=machine or H100, autotune=autotune)
    return op.sharded(x, w, schedule=schedule, mesh=mesh)


def traffic(
    shape: ccr.FCShape, strategy: str = "alg5", precision: str = "sp",
    machine=MANTICORE, clusters: int = 128,
) -> ccr.Traffic:
    """Predicted word traffic of this layer under Alg 4 or Alg 5 (the
    stack its capacity rule allows on ``machine``), whichever card runs
    the kernel."""
    if strategy == "alg4":
        return ccr.alg4_traffic(shape, clusters)
    if strategy == "alg5":
        stack = max(1, ccr.alg45_max_stack(shape, machine, precision))
        return ccr.alg5_traffic(shape, min(stack, shape.D_O), clusters)
    raise ValueError(strategy)
