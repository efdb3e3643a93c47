"""`cuda_op`: the registry that puts one Schedule/Planner layer behind every
hand-written CUDA kernel of the port (the counterpart of the JAX package's
``pallas_op``).

Two objects:

* :class:`CudaKernel` — one kernel as the device sees it: its launch
  wrapper (CUDA tensors only), its plain PyTorch version (the same function,
  for CPU tensors), its cost and a launch count.  It dispatches by device
  and nothing else: CPU tensors go to the plain version, CUDA tensors to
  the kernel, which raises on anything it does not take, and ``meta``
  tensors to the launch's checks and allocations with nothing launched
  (a dry run).  There is no fallback.
* :class:`CudaOp` — one op: planner + ``shape_args`` + the schedule-driven
  layout code around the kernel (``impl``: padding, strips, slicing), with
  plans cached per (planner, shapes); and, where the op has one, the
  multi-device execution of a :class:`ShardedSchedule` (``sharded_impl``:
  the psum tree, the ring, data parallelism over a
  :class:`~repro_torch.runtime.collectives.Mesh`).

:func:`with_reference_vjp` wires a layer's forward and planned backward
into one ``torch.autograd.Function``.  Ops resolve lazily by name
(:func:`get_op`), so ``repro_torch.plan`` never imports kernel code at
module load.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
import importlib
import threading
from typing import Any, Callable

import torch
import torch.nn.functional as F

from repro_torch.core.machine import H100, MachineModel
from repro_torch.plan.schedule import Schedule
from repro_torch.plan.sharded import ShardedSchedule, local_schedule, mesh_spec

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
    """One hand-written kernel: launch wrapper, plain version, cost, launch
    count.

    ``launch(kernel, *tensors, **params)`` checks its operands, allocates
    the outputs and calls :meth:`run` with the C arguments; ``plain`` takes
    the same arguments and computes the same function in plain PyTorch;
    ``cost(*tensors, **params)`` gives the call's (FLOPs, bytes): each
    input read once, each output written once (the definition of
    ``PERF.md``'s bound column, which reads the same functions).
    ``launches`` counts the kernel's launches (bumped only in :meth:`run`).
    ``symbol`` is the C entry point of f32 operands and ``bf16_symbol``,
    where the source has one, that of bf16 operands; ``routes`` maps a
    mixed route (the tuple of the operands' dtypes, in the launch's order,
    then the output's where the launch has a choice: the CNN's bf16
    activations against f32 weights) to its entry point.  All are in
    :attr:`symbols`.  The launch checks its operands with
    :meth:`operand_dtype` and passes the route to :meth:`run`.

    A call dispatches by device: CPU tensors run the plain version, CUDA
    tensors the launch, and ``meta`` tensors the launch with nothing
    launched: the same checks, outputs of the launch's shapes and dtypes,
    no count — the route of a dry run.  Every call reports itself, once,
    to the cost recorder in force (``analysis/hlo_cost.py``).
    """

    def __init__(self, name: str, *, source: str, symbol: str,
                 argtypes: list, launch: Callable, plain: Callable,
                 cost: Callable, bf16_symbol: str | None = None,
                 routes: dict[tuple, str] | None = None):
        self.name = name
        self.source = source  # file stem under kernels/csrc/
        # one operand dtype, or a mixed route's tuple -> C entry point
        self.symbols: dict = {torch.float32: symbol}
        if bf16_symbol is not None:
            self.symbols[torch.bfloat16] = bf16_symbol
        self.symbols.update(routes or {})
        self.argtypes = argtypes
        self.launch = launch
        self.plain = plain
        self.cost = cost
        self.launches = 0

    def __call__(self, *tensors: torch.Tensor, **params):
        device = tensors[0].device
        if any(t.device != device for t in tensors if t is not None):
            raise ValueError(f"{self.name}: operands on more than one device")
        if device.type not in ("cpu", "cuda", "meta"):
            raise ValueError(f"{self.name}: no kernel for device {device}")
        if device.type != "cpu" and torch.is_grad_enabled() and any(
                t is not None and t.requires_grad for t in tensors):
            raise NotImplementedError(f"{self.name}: {NOT_DIFFERENTIABLE}")
        rec = RECORDERS[-1] if RECORDERS else None
        with (rec.kernel(self.name, *self.cost(*tensors, **params)) if rec is not None
              else contextlib.nullcontext()):
            if device.type == "cpu":
                return self.plain(*tensors, **params)
            if device.type == "cuda":
                return self.launch(self, *tensors, **params)
            _DRY.depth = getattr(_DRY, "depth", 0) + 1
            try:
                return self.launch(self, *tensors, **params)
            finally:
                _DRY.depth -= 1

    def operand_dtype(self, *, out: torch.dtype | None = None,
                      **tensors: torch.Tensor) -> torch.dtype | tuple:
        """The route of a launch's operands (a key of :attr:`symbols`):
        their one dtype where they share one (and ``out``, where the launch
        names it, is that dtype too), else the tuple of their dtypes and
        ``out``'s.  Raise unless the kernel has an entry point for it and
        each operand is contiguous and 16-byte aligned."""
        one = [d for d in self.symbols if not isinstance(d, tuple)]
        known = set(one).union(*(d for d in self.symbols if isinstance(d, tuple)))
        takes = " or ".join(str(d).removeprefix("torch.") for d in one)
        for tname, t in tensors.items():
            if t.dtype not in known or not t.is_contiguous():
                raise ValueError(f"{self.name} kernel takes contiguous {takes} {tname}, "
                                 f"got {t.dtype} (contiguous={t.is_contiguous()})")
            if t.data_ptr() % 16:
                raise ValueError(f"{self.name} kernel needs a 16-byte aligned {tname}")
        dtypes = tuple(t.dtype for t in tensors.values())
        route = (dtypes[0] if len(set(dtypes)) == 1 and out in (None, dtypes[0])
                 else dtypes + ((out,) if out is not None else ()))
        if route not in self.symbols:
            mixed = "; ".join("/".join(_dtype_name(d) for d in key)
                              for key in self.symbols if isinstance(key, tuple))
            raise ValueError(
                f"{self.name} kernel takes {', '.join(tensors)} of one dtype"
                + (f" or a mixed route ({mixed})" if mixed else "") + ", got "
                + "/".join(_dtype_name(d) for d in dtypes + ((out,) if out else ())))
        return route

    def run(self, *c_args, dtype: torch.dtype | tuple = torch.float32) -> None:
        """Launch the compiled kernel of route ``dtype`` (from
        :meth:`operand_dtype`) on the current stream; raise on the error
        code its C entry point returns (``cudaGetLastError``).  On the
        ``meta`` route it returns at once: nothing is built or launched."""
        if getattr(_DRY, "depth", 0):
            return
        from repro_torch.kernels import _build

        lib = _build.load(self.source)
        fn = getattr(lib, self.symbols[dtype])
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        err = fn(*c_args, ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        if err:
            raise RuntimeError(
                f"{self.name}: CUDA error {err} ({_build.error_string(lib, err)})")
        self.launches += 1


def one_dtype(name: str, **tensors: torch.Tensor) -> torch.dtype:
    """The dtype ``tensors`` share; raise naming ``name`` when they do not
    (a kernel's and its plain version's operands are of one dtype)."""
    dtypes = {t.dtype for t in tensors.values()}
    if len(dtypes) > 1:
        raise ValueError(f"{name} takes {', '.join(tensors)} of one dtype, got "
                         + ", ".join(f"{n} {t.dtype}" for n, t in tensors.items()))
    return dtypes.pop()


def activation_dtype(name: str, weights: tuple = (), **tensors: torch.Tensor) -> torch.dtype:
    """The dtype of a kernel's activations (every operand not named in
    ``weights``): raise naming ``name`` unless they share one and each
    weight is of it too, or f32 against bf16 activations (the CNN's bf16
    route, where ``repro``'s type promotion meets bf16 activations with the
    f32 parameters)."""
    dtype = one_dtype(name, **{n: t for n, t in tensors.items() if n not in weights})
    for n in weights:
        w = tensors[n].dtype
        if w != dtype and not (dtype == torch.bfloat16 and w == torch.float32):
            raise ValueError(
                f"{name} takes its activations of one dtype and {n} of it or float32 "
                "against bfloat16, got " + ", ".join(f"{k} {t.dtype}"
                                                     for k, t in tensors.items()))
    return dtype


def _dtype_name(d: torch.dtype) -> str:
    return str(d).removeprefix("torch.")


_DRY = threading.local()  # > 0 inside a kernel call on meta tensors
# The cost recorders in force, innermost last: ``analysis/hlo_cost.py``'s
# ``record`` pushes one here, and every kernel call reports to the last.
RECORDERS: list = []


@dataclasses.dataclass(frozen=True)
class CudaOp:
    """One registered op: planner + shape extraction + implementation.

    ``shape_args(*tensors, **params)`` maps operands to the planner's
    keyword shapes; ``impl(*tensors, schedule=, **params)`` runs the op from
    a Schedule through ``kernel``; ``sharded_impl(*tensors, schedule=,
    mesh=, **params)`` runs a ShardedSchedule's strategy across a mesh.
    """

    name: str
    planner: type
    shape_args: Callable[..., dict[str, Any]]
    impl: Callable[..., Any]
    kernel: CudaKernel
    sharded_impl: Callable[..., Any] | None = None

    def planner_for(self, machine: MachineModel = H100, mesh=None,
                    shard_axis: str = "model", strategy: str | None = None):
        if mesh is None:
            return self.planner(machine)
        return self.planner(machine, mesh_spec(mesh), shard_axis, strategy)

    def plan(self, *tensors, machine: MachineModel = H100, autotune: str | None = None,
             **params) -> Schedule:
        """Plan from concrete operands (shapes/dtypes only are read), cached
        per (planner, shapes).  ``autotune`` overrides the process policy
        for this resolution — under "cache-only"/"tune" a measured winner
        beats the argmin (measured on the operands' device)."""
        shape = self.shape_args(*tensors, **params)
        tuned = _tuned(self.name, shape, machine, autotune, tensors[0].dtype,
                       tensors[0].device)
        if tuned is not None:
            return tuned
        return _cached_plan(self.planner(machine), tuple(sorted(shape.items())))

    def plan_sharded(self, *tensors, mesh, machine: MachineModel = H100,
                     axis: str = "model", strategy: str | None = None,
                     autotune: str | None = None, **params) -> ShardedSchedule:
        """Plan from concrete operands against a ``(machine, mesh)`` pair:
        the ShardedSchedule carries the device partitioning and the HBM/ICI
        word split (cached like :meth:`plan`; a cached winner for the
        ``(op, shapes, machine, mesh, axis, strategy)`` cell overrides the
        modeled psum-vs-ring-vs-batch pick)."""
        shape = self.shape_args(*tensors, **params)
        tuned = _tuned(self.name, shape, machine, autotune, tensors[0].dtype,
                       tensors[0].device, mesh=mesh_spec(mesh), axis=axis,
                       strategy=strategy)
        if tuned is not None:
            return tuned
        return _cached_plan(self.planner_for(machine, mesh, axis, strategy),
                            tuple(sorted(shape.items())))

    def __call__(self, *tensors, schedule: Schedule | ShardedSchedule | None = None,
                 machine: MachineModel = H100, autotune: str | None = None, **params):
        schedule = local_schedule(schedule)
        if schedule is None:
            schedule = local_schedule(self.plan(*tensors, machine=machine,
                                                autotune=autotune, **params))
        return self.impl(*tensors, schedule=schedule, **params)

    def sharded(self, *tensors, schedule: ShardedSchedule, mesh, **params):
        """Run a ShardedSchedule's strategy on a live mesh: every rank holds
        the global operands, the registered ``sharded_impl`` reads the
        partition off the schedule (psum tree, ring permutes, data
        parallelism) and returns the global output on every rank.  The
        "single" strategy (and any 1-wide shard group) runs the per-device
        impl on the local schedule."""
        if schedule.strategy == "single" or schedule.devices == 1:
            return self(*tensors, schedule=schedule.schedule, **params)
        if self.sharded_impl is None:
            raise NotImplementedError(
                f"op {self.name!r} registered no sharded_impl; strategy "
                f"{schedule.strategy!r} cannot execute through the registry")
        return self.sharded_impl(*tensors, schedule=schedule, mesh=mesh, **params)


@functools.lru_cache(maxsize=1024)
def _cached_plan(planner, shape_items: tuple) -> Schedule:
    """Planners are frozen dataclasses and shape kwargs are hashable ints,
    so identical (planner, shapes) pairs return the memoized Schedule."""
    return planner.plan(**dict(shape_items))


def _tuned(name, shape, machine, policy, dtype, device, mesh=None, axis="model",
           strategy=None):
    """The measured-time override for one schedule resolution (see
    repro_torch.plan.autotune), or ``None`` when the modeled argmin stands
    — policy "off" short-circuits before the autotuner is even imported."""
    from repro_torch.plan import autotune as _at

    if (policy or _at.get_policy()) == "off":
        return None
    return _at.tuned_schedule(name, shape, machine=machine, mesh=mesh, axis=axis,
                              strategy=strategy, policy=policy, dtype=dtype,
                              device=device)


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
            impl: Callable, kernel: CudaKernel,
            sharded_impl: Callable | None = None) -> CudaOp:
    """Register a kernel behind the plan layer (returns the op handle)."""
    op = CudaOp(name=name, planner=planner, shape_args=shape_args, impl=impl,
                kernel=kernel, sharded_impl=sharded_impl)
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
