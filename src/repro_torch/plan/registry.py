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

Ops resolve lazily by name (:func:`get_op`), so ``repro_torch.plan`` never
imports kernel code at module load.
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

TRAINING_SLICE = ("the port's kernels are forward only: gradients through "
                  "them arrive with the training slice (planned dgrad/wgrad "
                  "and dX/dW kernels)")


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
            raise NotImplementedError(f"{self.name}: {TRAINING_SLICE}")
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
    "matmul": "repro_torch.kernels.matmul.ops",
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
