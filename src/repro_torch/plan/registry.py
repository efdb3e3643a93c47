"""`cuda_op`: the registry that puts one Schedule/Planner layer behind every
hand-written CUDA kernel of the port (the counterpart of the JAX package's
``pallas_op``).

Two objects:

* :class:`CudaKernel` — one kernel as the device sees it: its launch
  wrapper (CUDA tensors only), its plain PyTorch version (the same function,
  for CPU tensors) and a launch count.  It dispatches by device and nothing
  else: CPU tensors go to the plain version, CUDA tensors to the kernel,
  which raises on anything it does not take.  There is no fallback.
* :class:`CudaOp` — one op: planner + ``shape_args`` + the schedule-driven
  layout code around the kernel (``impl``: padding, strips, slicing), with
  plans cached per (planner, shapes).

:func:`with_reference_vjp` wires a layer's forward and planned backward
into one ``torch.autograd.Function``.  Ops resolve lazily by name
(:func:`get_op`), so ``repro_torch.plan`` never imports kernel code at
module load.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import importlib
from typing import Any, Callable

import torch
import torch.nn.functional as F

from repro_torch.core.machine import H100, MachineModel
from repro_torch.plan.schedule import Schedule
from repro_torch.plan.sharded import ShardedSchedule, local_schedule

NOT_DIFFERENTIABLE = ("a kernel is not differentiable by itself: train through "
                      "the layer functions (core.conv_layer.conv_block/conv_layer, "
                      "core.fc_layer.fc_layer, the transformer's attention cell), "
                      "whose backward runs the planned dgrad/wgrad and dX/dW "
                      "kernels or the attention reference")


def pad_dim(x: torch.Tensor, axis: int, size: int) -> torch.Tensor:
    """Zero-pad one axis up to ``size`` (no-op when already there)."""
    have = x.shape[axis]
    if have == size:
        return x
    axis %= x.ndim
    pads = [0, 0] * (x.ndim - axis)
    pads[-1] = size - have
    return F.pad(x, pads)


class CudaKernel:
    """One hand-written kernel: launch wrapper, plain version, launch count.

    ``launch(kernel, *tensors, **params)`` checks its operands, allocates
    the outputs and calls :meth:`run` with the C arguments; ``plain`` takes
    the same arguments and computes the same function in plain PyTorch.
    ``launches`` counts the kernel's launches (bumped only in :meth:`run`).
    """

    def __init__(self, name: str, *, source: str, symbol: str,
                 argtypes: list, launch: Callable, plain: Callable):
        self.name = name
        self.source = source  # file stem under kernels/csrc/
        self.symbol = symbol
        self.argtypes = argtypes
        self.launch = launch
        self.plain = plain
        self.launches = 0

    def __call__(self, *tensors: torch.Tensor, **params):
        device = tensors[0].device
        if any(t.device != device for t in tensors if t is not None):
            raise ValueError(f"{self.name}: operands on more than one device")
        if device.type == "cpu":
            return self.plain(*tensors, **params)
        if device.type != "cuda":
            raise ValueError(f"{self.name}: no kernel for device {device}")
        if torch.is_grad_enabled() and any(
                t is not None and t.requires_grad for t in tensors):
            raise NotImplementedError(f"{self.name}: {NOT_DIFFERENTIABLE}")
        return self.launch(self, *tensors, **params)

    def run(self, *c_args) -> None:
        """Launch the compiled kernel on the current stream; raise on the
        error code its C entry point returns (``cudaGetLastError``)."""
        from repro_torch.kernels import _build

        lib = _build.load(self.source)
        fn = getattr(lib, self.symbol)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        err = fn(*c_args, ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        if err:
            raise RuntimeError(
                f"{self.name}: CUDA error {err} ({_build.error_string(lib, err)})")
        self.launches += 1


@dataclasses.dataclass(frozen=True)
class CudaOp:
    """One registered op: planner + shape extraction + implementation.

    ``shape_args(*tensors, **params)`` maps operands to the planner's
    keyword shapes; ``impl(*tensors, schedule=, **params)`` runs the op from
    a Schedule through ``kernel``.
    """

    name: str
    planner: type
    shape_args: Callable[..., dict[str, Any]]
    impl: Callable[..., Any]
    kernel: CudaKernel

    def plan(self, *tensors, machine: MachineModel = H100, **params) -> Schedule:
        """Plan from concrete operands (shapes/dtypes only are read), cached
        per (planner, shapes)."""
        shape = self.shape_args(*tensors, **params)
        return _cached_plan(self.planner(machine), tuple(sorted(shape.items())))

    def __call__(self, *tensors, schedule: Schedule | ShardedSchedule | None = None,
                 machine: MachineModel = H100, **params):
        schedule = local_schedule(schedule)
        if schedule is None:
            schedule = local_schedule(self.plan(*tensors, machine=machine, **params))
        return self.impl(*tensors, schedule=schedule, **params)


@functools.lru_cache(maxsize=1024)
def _cached_plan(planner, shape_items: tuple) -> Schedule:
    """Planners are frozen dataclasses and shape kwargs are hashable ints,
    so identical (planner, shapes) pairs return the memoized Schedule."""
    return planner.plan(**dict(shape_items))


_OPS: dict[str, CudaOp] = {}

# Ops register at import of their kernel package.
_PROVIDERS = {
    "conv2d": "repro_torch.kernels.conv2d.ops",
    "conv2d_im2col": "repro_torch.kernels.conv2d.im2col",
    "conv2d_dgrad": "repro_torch.kernels.conv2d.bwd",
    "conv2d_wgrad": "repro_torch.kernels.conv2d.bwd",
    "matmul": "repro_torch.kernels.matmul.ops",
    "matmul_dx": "repro_torch.kernels.matmul.bwd",
    "matmul_dw": "repro_torch.kernels.matmul.bwd",
    "flash_attention": "repro_torch.kernels.flash_attention.ops",
}


def cuda_op(name: str, *, planner: type, shape_args: Callable,
            impl: Callable, kernel: CudaKernel) -> CudaOp:
    """Register a kernel behind the plan layer (returns the op handle)."""
    op = CudaOp(name=name, planner=planner, shape_args=shape_args, impl=impl,
                kernel=kernel)
    _OPS[name] = op
    return op


def get_op(name: str) -> CudaOp:
    """Look up a registered op, importing its provider module if needed."""
    if name not in _OPS and name in _PROVIDERS:
        importlib.import_module(_PROVIDERS[name])
    try:
        return _OPS[name]
    except KeyError:
        raise KeyError(f"unknown cuda op {name!r}; known: "
                       f"{sorted(set(_OPS) | set(_PROVIDERS))}") from None


# ---------------------------------------------------------------------------
# Differentiable layers: forward kernel + planned backward
# ---------------------------------------------------------------------------


def with_reference_vjp(kernel_fn: Callable, *, bwd_fn: Callable,
                       nondiff_argnums: tuple[int, ...] = (),
                       fwd_fn: Callable | None = None) -> Callable:
    """One ``torch.autograd.Function`` around a layer: forward runs the
    kernel, backward runs ``bwd_fn`` (the planned backward kernels).

    ``nondiff_argnums`` are the trailing positional arguments (strides,
    strategies, Schedules): they ride as plain values and get ``None``
    gradients.  The others are tensors (or ``None``).  ``bwd_fn`` is called
    as ``bwd_fn(*diff_args, g, *nondiff_args, needs=...)`` — with
    ``fwd_fn`` as ``bwd_fn(*diff_args, aux, g, *nondiff_args, needs=...)``
    — where ``needs`` says which differentiable arguments want a gradient
    (``ctx.needs_input_grad``), and returns one gradient (or ``None``) per
    differentiable argument.

    ``fwd_fn`` (same signature as ``kernel_fn``) is the differentiated
    forward: it returns ``(out, aux)`` with a cheap auxiliary residual
    (the fused kernel's int8 epilogue mask) or ``None``.  A call is
    primal-only when grad mode is off or no differentiable argument
    requires grad; it runs ``kernel_fn`` directly and never pays for the
    aux output.
    """
    nondiff = tuple(nondiff_argnums)
    for i, j in zip(nondiff, nondiff[1:]):
        assert j == i + 1, "nondiff_argnums must be contiguous and trailing"

    def split(args):
        n_diff = len(args) - len(nondiff)
        assert not nondiff or nondiff[0] == n_diff, (
            f"nondiff_argnums {nondiff} are not the trailing arguments of "
            f"{len(args)}")
        return args[:n_diff], args[n_diff:]

    class _Op(torch.autograd.Function):
        @staticmethod
        def forward(ctx, *args):
            diff, rest = split(args)
            if fwd_fn is not None:
                out, ctx.aux = fwd_fn(*args)
            else:
                out, ctx.aux = kernel_fn(*args), None
            ctx.save_for_backward(*diff)
            ctx.rest = rest
            return out

        @staticmethod
        def backward(ctx, g):
            diff = ctx.saved_tensors
            needs = tuple(ctx.needs_input_grad[:len(diff)])
            aux = (ctx.aux,) if fwd_fn is not None else ()
            grads = tuple(bwd_fn(*diff, *aux, g, *ctx.rest, needs=needs))
            return grads + (None,) * len(ctx.rest)

    def op(*args):
        diff, _ = split(args)
        if not torch.is_grad_enabled() or not any(
                isinstance(t, torch.Tensor) and t.requires_grad for t in diff):
            return kernel_fn(*args)
        return _Op.apply(*args)

    return op
