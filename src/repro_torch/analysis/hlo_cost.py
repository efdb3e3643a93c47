"""The cost analysis of a traced step: per-device FLOPs, main-memory bytes
and collective bytes, counted as the step runs.

The JAX package's ``hlo_cost.py`` parses the optimized HLO text of a
compiled program.  A PyTorch program has no compiler and no HLO, so this
module keeps the name and reads the program another way: :func:`analyze`
runs ``fn`` eagerly under a ``TorchDispatchMode`` that sees every aten op
(forward and autograd's backward alike) and charges it by the JAX
package's *ideal-fusion* rules, under the HLO name the op would carry:

  * ``dot`` (``mm``, ``bmm``, ``addmm``, ``baddbmm``): 2·M·N·K FLOPs,
    operands + result bytes (an ``addmm`` bias is a fused add);
  * ``convolution`` (the plain path only): 2 · output elements · kernel
    elements per output, operands + results;
  * ``gather`` (embedding, ``index_select``, ``gather``, advanced
    indexing): 2 × result bytes (the rows touched, not the table);
  * ``scatter`` (``index_put_``, ``scatter_add``, ``index_add``, the
    embedding's backward) and ``dynamic-update-slice`` (``copy_`` into a
    slice of a larger tensor): 2 × update bytes;
  * ``copy`` (``clone``, ``_to_copy``, ``repeat``, a whole-tensor
    ``copy_`` on one device; a transfer from the host is free),
    ``transpose`` (a permuted view made contiguous) and
    ``concatenate`` (``cat``, ``stack``), and ``sort`` (``sort``,
    ``topk``): operands + result bytes;
  * ``reduce`` (sums, means, maxima, ``logsumexp``, norms, cumulative
    sums): result bytes only, one FLOP per element reduced;
  * elementwise ops: one FLOP per result element and no bytes (fused);
  * views, allocations and fills: free.

The port's hand-written kernels are charged once a call by their own
``cost`` (``plan/registry.py::CudaKernel``) under the kernel's name
(``matmul``, ``conv2d``, ``flash_attention``, ...): the aten ops that
make up a call on the card (the launch's allocations) or on the CPU (the
plain version) are not charged a second time.  On ``meta`` tensors a
kernel call checks its operands as the launch does, allocates its outputs
and launches nothing, so a dry run of a step on ``meta`` counts what the
card would run.

Collectives are recorded where ``runtime/collectives.py`` issues them,
as **result** bytes by the JAX package's categories (psum and pmax ->
``all-reduce``, ``all_gather`` -> ``all-gather``, ``reduce_scatter`` ->
``reduce-scatter``, ``ppermute`` -> ``collective-permute``), the
semantics of ``repro``'s ``collective_bytes``; a collective over an axis
of one rank issues nothing and records nothing.  (``collectives.STATS``
counts wire bytes instead, a different measure.)

Eager execution runs every loop iteration, so every trip is counted as
it runs and ``unknown_trip_whiles`` is always 0.  The recorder also
follows each result's storage from its allocation to its release: the
peak of the live temporaries, with the arguments' and the outputs' sizes,
stands in for ``compiled.memory_analysis()``.

All numbers are PER DEVICE: the step runs one rank's local shapes.  The
JAX package's HLO readers (``parse_module``, ``Instr``, ``shape_dims``,
``shape_bytes``) have no counterpart.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
import weakref
from typing import Any, Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.plan import registry
from repro_torch.runtime import collectives

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

# The port's collectives by kind -> the JAX package's HLO category.
COLLECTIVE_OF = {"all_reduce_sum": "all-reduce", "all_reduce_max": "all-reduce",
                 "all_gather": "all-gather", "reduce_scatter": "reduce-scatter",
                 "ppermute": "collective-permute", "all_to_all": "all-to-all"}

_DOT = {"mm", "bmm", "addmm", "baddbmm"}
_CONV = {"convolution", "convolution_backward"}
_GATHER = {"embedding", "index_select", "gather", "index"}
_SCATTER = {"index_put", "index_put_", "scatter_add", "scatter_add_", "scatter",
            "scatter_", "index_add", "index_add_", "embedding_dense_backward",
            "scatter_reduce", "scatter_reduce_"}
_COPY = {"clone", "_to_copy", "repeat"}
_SORT = {"sort", "topk"}
_REDUCE = {"sum", "mean", "amax", "amin", "max", "min", "argmax", "argmin", "prod",
           "any", "all", "logsumexp", "var", "var_mean", "std", "norm",
           "linalg_vector_norm", "cumsum", "cumprod", "_log_softmax", "_softmax"}
# Allocations, fills, metadata and host reads: no FLOP, no byte.
_FREE = {"empty", "empty_like", "empty_strided", "zeros", "zeros_like", "ones",
         "ones_like", "full", "full_like", "new_empty", "new_zeros", "new_ones",
         "new_full", "new_empty_strided", "arange", "fill_", "zero_", "fill",
         "scalar_tensor", "lift_fresh", "lift_fresh_copy", "_local_scalar_dense",
         "detach", "alias", "set_", "resize_", "_unsafe_view", "randn", "rand",
         "randint", "normal_", "uniform_", "bernoulli_", "equal", "is_nonzero",
         "item", "_assert_async", "sym_size", "sym_stride", "sym_numel"}


# Elementwise ops whose ``meta`` result a recorder makes itself (their
# Python meta functions cost 0.1-0.3 ms a call), on floating operands of
# one dtype only: name -> the result dtype rule ("promote": the operands'
# promoted type; "bool"; "same": the operand's).
_FAST = {**dict.fromkeys(("add", "sub", "mul", "maximum", "minimum", "where", "rsub"),
                         "promote"),
         **dict.fromkeys(("eq", "ne", "lt", "le", "gt", "ge", "logical_not", "logical_and",
                          "logical_or"), "bool"),
         **dict.fromkeys(("exp", "neg", "rsqrt", "sqrt", "tanh", "sigmoid", "silu", "log",
                          "abs", "reciprocal", "cos", "sin", "relu", "clamp", "square",
                          "gelu", "erf", "log1p", "expm1", "softplus"), "same")}


def _broadcast(ts) -> tuple | None:
    """The broadcast shape of the tensors ``ts`` (``None`` where they do
    not broadcast: the op's own check then raises)."""
    shape = tuple(ts[0].shape)
    for t in ts[1:]:
        other = tuple(t.shape)
        if other == shape:
            continue
        n = max(len(shape), len(other))
        a, b = (1,) * (n - len(shape)) + shape, (1,) * (n - len(other)) + other
        if any(x != y and x != 1 and y != 1 for x, y in zip(a, b)):
            return None
        shape = tuple(y if x == 1 else x for x, y in zip(a, b))
    return shape


def _fast_meta(func, args, kwargs):
    """The result of an elementwise op on ``meta`` operands, made without
    its meta function, or ``None`` where the op's layout or type rule is
    not the plain one (the caller then runs the op, whose meta function
    also raises where the card would).  The plain case: contiguous
    operands, all floating point and of one dtype (``where``'s condition
    boolean), and for an in-place op a result that casts to the operand
    written.  The result is contiguous, as the op's own would be."""
    name = func.overloadpacket.__name__
    inplace = name.endswith("_")
    base = name[:-1] if inplace else name
    rule = _FAST.get(base)
    if rule is None or func.is_view:
        return None
    ts = [a for a in args if isinstance(a, torch.Tensor)]
    if not ts or any(t.device.type != "meta" or not t.is_contiguous() for t in ts):
        return None
    if any(isinstance(v, torch.Tensor) for v in kwargs.values()):
        return None
    vals = ts[1:] if base == "where" else ts
    if base == "where" and (args[0] is not ts[0] or ts[0].dtype != torch.bool):
        return None
    if len({t.dtype for t in vals}) != 1 or not vals[0].dtype.is_floating_point:
        return None
    shape = _broadcast(ts)
    if shape is None:
        return None
    if rule == "bool":
        dtype = torch.bool
    elif rule == "same":
        dtype = vals[0].dtype
    else:
        ops = [a for a in (args[1:] if base == "where" else args)
               if isinstance(a, (torch.Tensor, int, float, bool))]
        if len(ops) > 2:
            return None
        dtype = ops[0].dtype if len(ops) == 1 else torch.result_type(ops[0], ops[1])
    if inplace:
        if tuple(shape) != tuple(args[0].shape) or args[0] is not ts[0] or (
                rule != "bool" and not torch.can_cast(dtype, args[0].dtype)):
            return None
        return args[0]
    return torch.empty(shape, dtype=dtype, device="meta")


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)
    elif isinstance(x, dict):
        for y in x.values():
            yield from _tensors(y)
    elif dataclasses.is_dataclass(x) and not isinstance(x, type):
        for f in dataclasses.fields(x):
            yield from _tensors(getattr(x, f.name))


@dataclasses.dataclass
class Cost:
    flops: float = 0.0
    bytes: float = 0.0
    coll: dict | None = None
    unknown_trip_whiles: int = 0
    by_op: dict | None = None  # op -> [flops, bytes] attribution

    def __post_init__(self):
        if self.coll is None:
            self.coll = {k: 0.0 for k in COLLECTIVES}
        if self.by_op is None:
            self.by_op = {}

    def bump(self, op: str, flops: float = 0.0, bytes: float = 0.0):
        self.flops += flops
        self.bytes += bytes
        e = self.by_op.setdefault(op, [0.0, 0.0])
        e[0] += flops
        e[1] += bytes

    def add(self, other: "Cost", mult: float = 1.0):
        self.flops += mult * other.flops
        self.bytes += mult * other.bytes
        for k in COLLECTIVES:
            self.coll[k] += mult * other.coll[k]
        for op, (f, b) in other.by_op.items():
            e = self.by_op.setdefault(op, [0.0, 0.0])
            e[0] += mult * f
            e[1] += mult * b
        self.unknown_trip_whiles += other.unknown_trip_whiles


def charge(func, args, out) -> tuple[str, float, float] | None:
    """(HLO op name, FLOPs, bytes) of one aten call under the
    ideal-fusion rules (module docstring), or ``None`` for a free op."""
    name = func.overloadpacket.__name__
    if func.is_view or name in _FREE or func.namespace != "aten":
        return None
    outs = list(_tensors(out))
    if not outs:
        return None
    res = sum(_nbytes(t) for t in outs)
    if name in _DOT:
        a, b = (args[0], args[1]) if name in ("mm", "bmm") else (args[1], args[2])
        k = a.shape[-1]
        return "dot", 2.0 * outs[0].numel() * k, float(_nbytes(a) + _nbytes(b) + res)
    if name in _CONV:
        w = args[1] if name == "convolution" else args[2]
        per_out = math.prod(w.shape) // w.shape[0]  # in-channels/groups x taps
        if name == "convolution":
            return ("convolution", 2.0 * outs[0].numel() * per_out,
                    float(_nbytes(args[0]) + _nbytes(w) + res))
        # (grad_output, input, weight): dX and dW are one conv each
        convs = sum(1 for t in out[:2] if t is not None)
        return ("convolution", 2.0 * args[0].numel() * per_out * convs,
                float(_nbytes(args[0]) + _nbytes(args[1]) + _nbytes(w) + res))
    if name in _GATHER:
        return "gather", 0.0, 2.0 * res
    if name in _SCATTER:
        upd = args[0] if name == "embedding_dense_backward" else next(
            (a for a in reversed(args) if isinstance(a, torch.Tensor)), None)
        return "scatter", 0.0, 2.0 * _nbytes(upd)
    if name == "copy_":
        dst, src = args[0], args[1]
        if dst.numel() < dst.untyped_storage().nbytes() // max(1, dst.element_size()):
            return "dynamic-update-slice", 0.0, 2.0 * _nbytes(src)
        return "copy", 0.0, float(_nbytes(src) + _nbytes(dst))
    if name in _COPY:
        if outs[0].device != args[0].device:
            return None  # a transfer from the host, not device work
        op = "transpose" if name == "clone" and not args[0].is_contiguous() else "copy"
        return op, 0.0, float(_nbytes(args[0]) + res)
    if name in ("cat", "stack"):
        return "concatenate", 0.0, float(sum(_nbytes(t) for t in args[0]) + res)
    if name in _SORT:
        return "sort", 0.0, float(_nbytes(args[0]) + res)
    if name in _REDUCE:
        src = args[0]
        return "reduce", float(src.numel()), float(_nbytes(outs[0]))
    return name, float(sum(t.numel() for t in outs)), 0.0


class Recorder(TorchDispatchMode):
    """Charges every aten op it sees to :attr:`cost` (per device), counts
    the port's kernel calls (:attr:`kernel_calls`) and every collective
    (:attr:`collective_calls`: category, shape, dtype, result bytes), and
    follows the storages its ops allocate (:attr:`memory`)."""

    def __init__(self):
        super().__init__()
        self.cost = Cost()
        self.kernel_calls: dict[str, int] = {}
        self.collective_calls: list[tuple] = []
        self._quiet = threading.local()
        self._arg_keys: set = set()
        self._refs: dict = {}  # storage key -> [live tensors, bytes]
        self.live = self.peak = 0
        self.argument_bytes = self.output_bytes = 0

    # -- aten ops ----------------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = _fast_meta(func, args, kwargs)
        if out is None:
            out = func(*args, **kwargs)
        if not getattr(self._quiet, "depth", 0):
            c = charge(func, args, out)
            if c is not None:
                self.cost.bump(*c)
        for t in _tensors(out):
            self._track(t)
        return out

    @contextlib.contextmanager
    def quiet(self):
        """A block whose aten ops are not charged (in this thread)."""
        self._quiet.depth = getattr(self._quiet, "depth", 0) + 1
        try:
            yield
        finally:
            self._quiet.depth -= 1

    @contextlib.contextmanager
    def kernel(self, name: str, flops: float, nbytes: float):
        """One call of a port kernel: charged ``flops``/``nbytes`` under
        ``name``; the aten ops inside the call are not charged."""
        self.kernel_calls[name] = self.kernel_calls.get(name, 0) + 1
        self.cost.bump(name, flops, nbytes)
        with self.quiet():
            yield

    def collective(self, kind: str, result: torch.Tensor) -> None:
        """One collective of the port's ``kind`` with this ``result``."""
        cat = COLLECTIVE_OF[kind]
        b = float(_nbytes(result))
        self.cost.coll[cat] += b
        self.cost.bump(cat, bytes=b)  # the payload also moves through HBM
        self.collective_calls.append((cat, tuple(result.shape), str(result.dtype), b))

    # -- memory ------------------------------------------------------------------------

    @staticmethod
    def _key(t: torch.Tensor):
        try:
            return t.untyped_storage()._cdata
        except (RuntimeError, NotImplementedError):
            return None

    def _track(self, t: torch.Tensor) -> None:
        key = self._key(t)
        if key is None or key in self._arg_keys:
            return
        entry = self._refs.get(key)
        if entry is None:
            entry = self._refs[key] = [0, t.untyped_storage().nbytes()]
            self.live += entry[1]
            self.peak = max(self.peak, self.live)
        entry[0] += 1
        weakref.finalize(t, self._release, key)

    def _release(self, key) -> None:
        entry = self._refs.get(key)
        if entry is None:
            return
        entry[0] -= 1
        if entry[0] == 0:
            self.live -= entry[1]
            del self._refs[key]

    def hold_arguments(self, args) -> None:
        """The arguments' storages: counted once, never as temporaries."""
        for t in _tensors(args):
            key = self._key(t)
            if key is not None and key not in self._arg_keys:
                self._arg_keys.add(key)
                self.argument_bytes += t.untyped_storage().nbytes()

    def hold_outputs(self, out) -> None:
        seen = set()
        for t in _tensors(out):
            key = self._key(t)
            if key is not None and key not in self._arg_keys and key not in seen:
                seen.add(key)
                self.output_bytes += t.untyped_storage().nbytes()

    @property
    def memory(self) -> dict:
        """``memory_analysis()``'s sizes: arguments, outputs and the peak
        of the storages the step allocated (outputs included)."""
        return {"argument_size_in_bytes": self.argument_bytes,
                "output_size_in_bytes": self.output_bytes,
                "temp_size_in_bytes": self.peak}


@contextlib.contextmanager
def record(*args):
    """A :class:`Recorder` in force for the block (``args``: the
    arguments whose storages are not temporaries).  On ``meta`` tensors a
    boolean-mask index selects every element (its count is data, which a
    dry run has not: the trace charges the most the index could take)."""
    from torch.fx.experimental import _config as fx_config

    rec = Recorder()
    rec.hold_arguments(args)
    hooks = (registry.RECORDERS, collectives.RECORDERS)  # the layers that report to it
    for h in hooks:
        h.append(rec)
    try:
        with fx_config.patch(meta_nonzero_assume_all_nonzero=True), rec:
            yield rec
    finally:
        for h in hooks:
            h.remove(rec)


def trace(fn: Callable, *args, **kwargs) -> tuple[Any, Recorder]:
    """(``fn(*args, **kwargs)``, the recorder that watched it)."""
    with record(args, kwargs) as rec:
        out = fn(*args, **kwargs)
        rec.hold_outputs(out)
    return out, rec


def analyze(fn: Callable, *args, **kwargs) -> Cost:
    """The per-device :class:`Cost` of running ``fn(*args, **kwargs)``."""
    return trace(fn, *args, **kwargs)[1].cost
