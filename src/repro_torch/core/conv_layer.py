"""The paper's convolutional layer as a differentiable module.

``strategy`` selects the paper algorithm, as a constraint handed to the
:class:`repro_torch.plan.ConvPlanner`:
  * "alg1"  - the narrowest output stack the machine's kernel runs: one
              depth slice on Manticore, one lane (8 channels, a thread
              item) on the H100;
  * "alg2"  - Delta_O output stacking at the full-plane strip;
  * "strip" - Alg 2 + spatial strip tiling: the planner trades strip height
              against Delta_O (and, unpinned, direct against im2col);
  * "alg3"  - Alg 2's blocking within each device; its ring reuse of input
              slices across devices is core/ring.py's, which a mesh runs
              (``plan(..., mesh=)``, ``fc_layer_sharded(strategy="ring")``);
              on one device it runs Alg 2's kernel.
An explicit :class:`repro_torch.plan.Schedule` (``schedule=``) overrides the
planner.  :func:`conv_block` fuses bias + ReLU + optional max-pool into the
kernel's flush.

Backward is planned too: autograd runs the ``conv2d_dgrad`` kernel (the
direct conv on the transposed geometry) for dX and the ``conv2d_wgrad``
kernel for dF, each scheduled by its own planner — pin them with
``bwd_schedules={"dgrad": ..., "wgrad": ..., "recompute": ...}`` (see
:func:`plan_bwd`).  :func:`conv_block` saves the forward kernel's int8
epilogue mask and scatters dY through it (no recompute conv); where the
forward cannot emit one (im2col schedules, ragged pool tails) the backward
recomputes the pre-epilogue activation (in f32).  dY keeps its dtype
into the kernels (bf16 on the CNN's bf16 route, as ``repro``'s kernels
receive it), which write f32 dX and dW, cast to x's and f's dtypes; the
bias gradient is dY's sum in f32.  dX is skipped when the input needs no
gradient (a model's images).  :func:`traffic` gives the paper's
closed-form traffic of each strategy on a machine (Manticore by default).  A backward schedule that does not
fit its machine raises on the card; on CPU tensors it warns once and runs
the kernels' plain versions with its blocks.
"""

from __future__ import annotations

import warnings

import torch

from repro_torch.core import ccr
from repro_torch.core.machine import H100, MANTICORE, machine_named
from repro_torch.kernels.conv2d.bwd import (
    conv2d_dgrad, conv2d_wgrad, dilate_crop, epilogue_scatter,
)
from repro_torch.kernels.conv2d.ops import (
    _fused_pool, _zero_bias, conv2d, conv2d_with_mask, conv_out_extent,
)
from repro_torch.kernels.conv2d.ref import maxpool_ref
from repro_torch.kernels.matmul.matmul import unrounded_dtype
from repro_torch.plan import Schedule, ShardedSchedule, get_op, local_schedule
from repro_torch.plan.planners import PlanRejected
from repro_torch.plan.registry import with_reference_vjp

# The machine backward schedules are planned (and fit-checked) against.
_BWD_MACHINE = H100

_WARNED_SCHEDULES: set = set()  # (role, schedule) pairs already reported


def warn_unfit_schedule(role: str, sched: Schedule, machine) -> None:
    """Warn exactly once per (role, schedule) when a fit gate passes an
    unfit backward schedule on to the plain versions; replays of the same
    unfit cell stay quiet."""
    key = (role, sched)
    if key in _WARNED_SCHEDULES:
        return
    _WARNED_SCHEDULES.add(key)
    warnings.warn(
        f"backward schedule {role!r} (op={sched.op!r}, grid={sched.grid}) "
        f"overflows local memory: working set {sched.vmem_bytes} B > "
        f"{machine.usable_for_working_set(2)} B usable on {machine.name!r}; "
        f"running its blocks on the kernels' plain versions (CPU tensors)",
        stacklevel=4)


def admit_schedule(role: str, sched: Schedule, on_card: bool) -> None:
    """The fit gate of a backward schedule: one that overflows its
    machine's local memory has no launch on the card and raises there; on
    CPU tensors the kernels' plain versions take its blocks, after one
    warning per (role, schedule)."""
    m = machine_named(sched.machine, _BWD_MACHINE)
    if sched.fits(m):
        return
    if on_card:
        raise ValueError(
            f"backward schedule {role!r} (op={sched.op!r}) needs "
            f"{sched.vmem_bytes} B of local memory, more than the "
            f"{m.usable_for_working_set(2)} B usable on {m.name!r}")
    warn_unfit_schedule(role, sched, m)


def strategy_pins(strategy: str, H_O: int, machine=H100) -> tuple:
    """Map a paper strategy onto planner constraints (block_do, block_h):
    Alg 1 pins the narrowest stack the machine's kernel runs, Algs 2 and 3
    the full output plane; None leaves a block to the planner."""
    block_do = machine.lane if strategy == "alg1" else None
    block_h = None if strategy in ("strip", "alg1") else max(1, H_O)
    return block_do, block_h


def _strategy_blocks(strategy, x, f, stride, padding):
    return strategy_pins(strategy, conv_out_extent(x.shape[-3], padding, f.shape[0], stride))


def _planned_conv_backward(x, f, dy, stride, padding, sd, *, needs_dx=True,
                           mask=None, pool=1):
    """(dX or None, dW, full-rate dY) through the planned backward kernels;
    ``sd`` maps {"dgrad"/"wgrad": Schedule} pins.  With ``mask``/``pool``
    ``dy`` is the pooled cotangent: the schedules are planned as the
    fused-epilogue variants and the scatter runs once, shared by both
    kernels and the bias gradient (in ``repro`` XLA's CSE merges the
    copies).  At padding > F - 1 (``repro`` takes XLA's reference VJP
    there) dX is the same kernel's stride-1 dgrad of the dilated dY
    cropped by P - (F - 1) in front (:func:`dilate_crop`), planned by
    ``ConvDgradPlanner`` at that geometry."""
    F = f.shape[0]
    crop = padding - (F - 1)
    out_hw = (x.shape[-3], x.shape[-2])
    s_dg = local_schedule(sd.get("dgrad"))
    if needs_dx and s_dg is None and crop <= 0:
        s_dg = get_op("conv2d_dgrad").plan(
            dy, f, stride=stride, padding=padding, out_hw=out_hw, mask=mask, pool=pool)
    s_wg = local_schedule(sd.get("wgrad"))
    if s_wg is None:
        s_wg = get_op("conv2d_wgrad").plan(
            x, dy, F=F, stride=stride, padding=padding, mask=mask, pool=pool)
    if mask is not None:
        dy = epilogue_scatter(dy, mask, pool)
    dg, dg_stride, dg_padding = dy, stride, padding
    if needs_dx and crop > 0:
        dg, dg_stride, dg_padding = dilate_crop(dy, stride, crop, out_hw, F), 1, F - 1
        if s_dg is None:
            s_dg = get_op("conv2d_dgrad").plan(dg, f, stride=1, padding=F - 1,
                                               out_hw=out_hw)
    for role, s in (("dgrad", s_dg if needs_dx else None), ("wgrad", s_wg)):
        if s is not None:
            admit_schedule(role, s, x.is_cuda)
    dx = None
    if needs_dx:
        dx = conv2d_dgrad(dg, f, stride=dg_stride, padding=dg_padding, out_hw=out_hw,
                          schedule=s_dg).to(x.dtype)
    dw = conv2d_wgrad(x, dy, F=F, stride=stride, padding=padding,
                      schedule=s_wg).to(f.dtype)
    return dx, dw, dy


# -- conv_layer ------------------------------------------------------------------


def _conv_layer_kernel(x, f, stride, padding, strategy, schedule, bwd_schedules):
    del bwd_schedules  # consumed by the backward pass
    block_do, block_h = _strategy_blocks(strategy, x, f, stride, padding)
    return conv2d(x, f, stride=stride, padding=padding, schedule=schedule,
                  block_do=block_do, block_h=block_h)


def _conv_layer_bwd(x, f, g, stride, padding, strategy, schedule, bwd_schedules,
                    *, needs):
    del strategy, schedule
    dx, dw, _ = _planned_conv_backward(x, f, g, stride, padding,
                                       dict(bwd_schedules or ()), needs_dx=needs[0])
    return dx, dw


_conv_layer_vjp = with_reference_vjp(
    _conv_layer_kernel, nondiff_argnums=(2, 3, 4, 5, 6), bwd_fn=_conv_layer_bwd,
)


def conv_layer(x, f, stride=1, padding=0, strategy="alg2",
               schedule: Schedule | ShardedSchedule | None = None,
               bwd_schedules=None):
    """x: [B, H, W, D_I] or [H, W, D_I]; f: [F, F, D_I, D_O].

    ``bwd_schedules`` optionally maps {"dgrad"/"wgrad": Schedule} to pin the
    planned backward kernels' blocking (see :func:`plan_bwd`)."""
    return _conv_layer_vjp(x, f, stride, padding, strategy,
                           local_schedule(schedule), bwd_schedules)


# -- conv_block: conv + bias + ReLU (+ pool), the epilogue fused ------------------------


def _conv_block_kernel(x, f, b, stride, padding, pool, strategy, schedule,
                       bwd_schedules):
    del bwd_schedules  # consumed by the backward pass
    block_do, block_h = _strategy_blocks(strategy, x, f, stride, padding)
    return conv2d(x, f, bias=b, stride=stride, padding=padding, relu=True,
                  pool=pool, schedule=schedule, block_do=block_do, block_h=block_h)


def _conv_block_fwd(x, f, b, stride, padding, pool, strategy, schedule,
                    bwd_schedules):
    """The differentiated forward: the primal output plus the int8
    epilogue mask as the auxiliary residual (None where the fused flush
    cannot emit it: im2col schedules, ragged pool tails)."""
    del bwd_schedules  # consumed by the backward pass
    block_do, block_h = _strategy_blocks(strategy, x, f, stride, padding)
    if schedule is None:
        bias = b if b is not None else _zero_bias(f)
        schedule = get_op("conv2d").plan(
            x, f, bias, stride=stride, padding=padding, relu=True, pool=pool,
            block_do=block_do, block_h=block_h)
    return conv2d_with_mask(x, f, bias=b, stride=stride, padding=padding,
                            pool=pool, schedule=local_schedule(schedule))


def _bias_grad(dy, b):
    """db: dY summed over every axis but the channels, in f32 where dY is
    bf16 (``repro`` sums the f32 upcast of its cotangent), cast to b's
    dtype."""
    dims = tuple(range(dy.ndim - 1))
    db = dy.sum(dims, dtype=torch.float32) if dy.dtype == torch.bfloat16 else dy.sum(dims)
    return db.to(b.dtype)


def _conv_block_bwd(x, f, b, aux, g, stride, padding, pool, strategy, schedule,
                    bwd_schedules, *, needs):
    del strategy, schedule
    sd = dict(bwd_schedules or ())
    needs_dx = needs[0]
    if aux is not None:
        # Fused-epilogue backward: dY scatters through the saved mask; no
        # recompute conv.
        dx, dw, dy = _planned_conv_backward(x, f, g, stride, padding, sd,
                                            needs_dx=needs_dx, mask=aux, pool=pool)
    else:
        # No mask: rematerialize the pre-epilogue activation (in f32, as
        # repro's out_dtype=f32) with the planned forward kernel, backprop
        # ReLU/pool in plain PyTorch, then run the planned transposed kernels
        # on dY.  An unfit pinned recompute schedule is dropped (loudly,
        # once) for the planner's own.
        recompute = local_schedule(sd.get("recompute"))
        if recompute is not None:
            m = machine_named(recompute.machine, _BWD_MACHINE)
            if not recompute.fits(m):
                warn_unfit_schedule("recompute", recompute, m)
                recompute = None
        y0 = conv2d(x, f, bias=b, stride=stride, padding=padding, relu=False,
                    pool=1, schedule=recompute, out_dtype=unrounded_dtype(x.dtype))
        dx, dw, dy = _planned_conv_backward(x, f, _epilogue_vjp(y0, g, pool), stride,
                                            padding, sd, needs_dx=needs_dx)
    return dx, dw, _bias_grad(dy, b)


def _epilogue_vjp(y0, g, pool):
    """dY of the ReLU (+ pool) epilogue at the pre-epilogue activation, in
    g's dtype: the decisions are taken on ``y0`` (f32), the VJP routes g's
    values (a tie splits them evenly, exact at a 2- or 4-way tie)."""
    with torch.enable_grad():
        y = y0.detach().requires_grad_(True)
        out = torch.relu(y)
        if pool > 1:
            out = maxpool_ref(out, pool)
        return torch.autograd.grad(out, y, g.to(y0.dtype))[0].to(g.dtype)


_conv_block_vjp = with_reference_vjp(
    _conv_block_kernel, nondiff_argnums=(3, 4, 5, 6, 7, 8),
    bwd_fn=_conv_block_bwd, fwd_fn=_conv_block_fwd,
)


def conv_block(x, f, b, stride=1, padding=0, pool=1, strategy="strip",
               schedule: Schedule | ShardedSchedule | None = None,
               bwd_schedules=None):
    """Fused conv + bias + ReLU (+ optional ``pool x pool`` max-pool), the
    whole epilogue in the kernel's flush.  ``x``: [B, H, W, D_I] or
    [H, W, D_I]; ``f``: [F, F, D_I, D_O]; ``b``: [D_O].  ``bwd_schedules``
    ({"dgrad"/"wgrad"/"recompute": Schedule}) pins the planned backward."""
    return _conv_block_vjp(x, f, b, stride, padding, pool, strategy,
                           local_schedule(schedule), bwd_schedules)


# -- planning ----------------------------------------------------------------------


def plan(x_shape, f_shape, *, stride=1, padding=0, pool=1, in_bytes=4,
         machine=None, strategy="strip", mesh=None, shard_axis="data",
         shard_strategy=None, algorithm=None, autotune=None):
    """Plan this layer without running it: the Schedule the kernel would
    use for operands of these shapes.  With ``mesh=`` the mesh-aware
    planner returns a ShardedSchedule: the device partitioning ("batch" or
    "stack" data parallelism over ``shard_axis``, pinnable with
    ``shard_strategy=``) plus the HBM/ICI word split; a single-device mesh
    degenerates to the meshless Schedule.  ``algorithm`` pins one family of the
    two-level argmin ("direct" / "im2col"); the default lets both compete
    (the paper strategies pin blocks as :func:`strategy_pins` maps them,
    the same pins the layer's forward plans with).  ``autotune`` ("off" |
    "cache-only" | "tune", default the process policy) lets a measured
    winner for this cell override the argmin.  On the H100 a schedule that
    does not fit one block's shared memory raises ``PlanRejected``: no
    kernel launches it."""
    from repro_torch.plan import autotune as at

    machine = machine or H100
    B = x_shape[0] if len(x_shape) == 4 else 1
    H, W, d_in = x_shape[-3], x_shape[-2], x_shape[-1]
    F, d_out = f_shape[0], f_shape[3]
    H_O = conv_out_extent(H, padding, F, stride)
    W_O = conv_out_extent(W, padding, F, stride)
    block_do, block_h = strategy_pins(strategy, H_O, machine)
    s = at.resolve("conv2d", dict(
        H_O=H_O, W_O=W_O, F=F, S=stride, d_in=d_in, d_out=d_out,
        in_bytes=in_bytes, pool=_fused_pool(H_O, W_O, pool), batch=B,
        padding=padding, H_I=H, W_I=W, block_do=block_do, block_h=block_h,
        algorithm=algorithm), machine=machine, mesh=mesh, axis=shard_axis,
        strategy=shard_strategy, policy=autotune)
    if machine.name == H100.name and not s.fits(machine):
        # The CUDA kernels take only blocks that fit one block's shared
        # memory (as ``candidates()`` keeps on the H100).
        raise PlanRejected(
            f"conv2d: strategy {strategy!r} at {tuple(x_shape)} x {tuple(f_shape)} "
            f"needs {local_schedule(s).vmem_bytes} B of shared memory, more than the "
            f"{machine.usable_for_working_set(2)} B one block holds")
    return s


def plan_bwd(x_shape, f_shape, *, stride=1, padding=0, pool=None, in_bytes=4,
             machine=None, mesh=None, shard_axis="data", autotune=None) -> dict:
    """Backward-pass Schedules for this layer's shapes: the dgrad and
    wgrad kernels autograd will run, plus — on the recompute path only —
    the pre-epilogue recompute conv of :func:`conv_block`.  Pass (a subset
    of) the result back via ``bwd_schedules=`` to pin the blocking.

    ``pool`` opts into the fused-epilogue backward: when given and the
    output plane tiles evenly, the dgrad cell is planned as its
    ``fused_epilogue`` variant and the "recompute" entry is dropped.
    Geometries outside the dgrad contract (padding > F-1) return no
    "dgrad" key.  With ``mesh=`` every entry is a ShardedSchedule: dgrad
    and the recompute shard with the batch (no collective), the wgrad
    charges the Alg-4 tree reduction of dF as ici_words.  The backward
    cells autotune through the same ``autotune=`` policy as the forward
    (each op is its own cache cell).
    """
    from repro_torch.plan import autotune as at

    machine = machine or _BWD_MACHINE
    B = x_shape[0] if len(x_shape) == 4 else 1
    H, W, d_in = x_shape[-3], x_shape[-2], x_shape[-1]
    F, d_out = f_shape[0], f_shape[3]
    H_O = conv_out_extent(H, padding, F, stride)
    W_O = conv_out_extent(W, padding, F, stride)
    fused = pool is not None and _fused_pool(H_O, W_O, pool) == pool

    def res(op, **shape):
        return at.resolve(op, shape, machine=machine, mesh=mesh, axis=shard_axis,
                          policy=autotune)

    out = {
        "wgrad": res(
            "conv2d_wgrad",
            H_O=H_O, W_O=W_O, F=F, S=stride, d_in=d_in, d_out=d_out,
            in_bytes=in_bytes, batch=B, padding=padding, H_I=H, W_I=W),
    }
    if not fused:
        out["recompute"] = res(
            "conv2d",
            H_O=H_O, W_O=W_O, F=F, S=stride, d_in=d_in, d_out=d_out,
            in_bytes=in_bytes, pool=1, batch=B, padding=padding, H_I=H, W_I=W)
    if padding <= F - 1:
        out["dgrad"] = res(
            "conv2d_dgrad",
            H_O=H_O, W_O=W_O, F=F, S=stride, P=padding, d_in=d_in,
            d_out=d_out, in_bytes=in_bytes, batch=B, H_I=H, W_I=W,
            pool=pool if fused else None)
    return out


# -- the paper's analysis ------------------------------------------------------------


def traffic(
    shape: ccr.ConvShape, strategy: str = "alg2", precision: str = "sp",
    machine=MANTICORE, h_block: int | None = None,
) -> ccr.Traffic:
    """Predicted word traffic of this layer (one image) under the chosen
    algorithm: the paper's closed forms with the stack its capacity rule
    allows on ``machine``, whichever card runs the kernel."""
    if strategy == "alg1":
        return ccr.alg1_traffic(shape)
    if strategy == "alg2":
        return ccr.alg2_traffic(shape, max(1, ccr.alg2_max_stack(shape, machine, precision)))
    if strategy == "strip":
        hb = h_block or max(1, shape.W_O // 2)
        stack = max(1, ccr.alg2_strip_max_stack(shape, machine, precision, hb))
        return ccr.alg2_strip_traffic(shape, stack, hb)
    if strategy == "alg3":
        return ccr.alg3_traffic(shape, max(1, ccr.alg3_max_stack(shape, machine, precision)))
    raise ValueError(strategy)
