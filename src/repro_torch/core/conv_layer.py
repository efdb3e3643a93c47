"""The paper's convolutional layer, forward.

``strategy`` selects the paper algorithm, as a constraint handed to the
:class:`repro_torch.plan.ConvPlanner`:
  * "alg1"  - the narrowest output stack the machine's kernel runs: one
              depth slice on Manticore, one lane (8 channels, a thread
              item) on the H100;
  * "alg2"  - Delta_O output stacking at the full-plane strip;
  * "strip" - Alg 2 + spatial strip tiling: the planner trades strip height
              against Delta_O (and, unpinned, direct against im2col).
An explicit :class:`repro_torch.plan.Schedule` (``schedule=``) overrides the
planner.  :func:`conv_block` fuses bias + ReLU + optional max-pool into the
kernel's flush.  The port is forward only so far.
"""

from __future__ import annotations

from repro_torch.core.machine import H100
from repro_torch.kernels.conv2d.ops import _fused_pool, conv2d, conv_out_extent
from repro_torch.plan import Schedule, ShardedSchedule, local_schedule, planner_for


def _strategy_blocks(strategy, x, f, stride, padding, machine=H100):
    """Map a paper strategy onto planner constraints (block_do, block_h)."""
    block_do = machine.lane if strategy == "alg1" else None  # None -> planner
    block_h = None
    if strategy not in ("strip", "alg1"):  # full plane
        block_h = max(1, conv_out_extent(x.shape[-3], padding, f.shape[0], stride))
    return block_do, block_h


def conv_layer(x, f, stride=1, padding=0, strategy="alg2",
               schedule: Schedule | ShardedSchedule | None = None):
    """x: [B, H, W, D_I] or [H, W, D_I]; f: [F, F, D_I, D_O]."""
    block_do, block_h = _strategy_blocks(strategy, x, f, stride, padding)
    return conv2d(x, f, stride=stride, padding=padding,
                  schedule=local_schedule(schedule),
                  block_do=block_do, block_h=block_h)


def conv_block(x, f, b, stride=1, padding=0, pool=1, strategy="strip",
               schedule: Schedule | ShardedSchedule | None = None):
    """Fused conv + bias + ReLU (+ optional ``pool x pool`` max-pool), the
    whole epilogue in the kernel's flush.  ``x``: [B, H, W, D_I] or
    [H, W, D_I]; ``f``: [F, F, D_I, D_O]; ``b``: [D_O]."""
    block_do, block_h = _strategy_blocks(strategy, x, f, stride, padding)
    return conv2d(x, f, bias=b, stride=stride, padding=padding, relu=True,
                  pool=pool, schedule=local_schedule(schedule),
                  block_do=block_do, block_h=block_h)


def plan(x_shape, f_shape, *, stride=1, padding=0, pool=1, in_bytes=4,
         machine=None, strategy="strip", algorithm=None) -> Schedule:
    """Plan this layer without running it: the Schedule the kernel would
    use for operands of these shapes.  ``algorithm`` pins one family of the
    two-level argmin ("direct" / "im2col"); the default lets both compete
    (the paper strategies "alg1"/"alg2" pin direct-kernel blocks)."""
    machine = machine or H100
    B = x_shape[0] if len(x_shape) == 4 else 1
    H, W, d_in = x_shape[-3], x_shape[-2], x_shape[-1]
    F, d_out = f_shape[0], f_shape[3]
    H_O = conv_out_extent(H, padding, F, stride)
    W_O = conv_out_extent(W, padding, F, stride)
    block_do = machine.lane if strategy == "alg1" else None
    block_h = H_O if strategy == "alg2" else None
    return planner_for("conv2d", machine).plan(
        H_O=H_O, W_O=W_O, F=F, S=stride, d_in=d_in, d_out=d_out,
        in_bytes=in_bytes, pool=_fused_pool(H_O, W_O, pool), batch=B,
        padding=padding, H_I=H, W_I=W, block_do=block_do, block_h=block_h,
        algorithm=algorithm)
