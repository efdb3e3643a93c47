"""Measured-time Schedule autotuning with a persistent per-cell cache: the
JAX package's ``plan/autotune.py`` for one device, timing the port's CUDA
kernels.

The planners' argmin is a *model*: modeled main-memory words under the
paper's capacity argument.  This module adds the measured-time mode on top
of it:

  * every planner exposes its enumeration (``Planner.candidates()``: the
    blocking ladder; on the H100 only the candidates the port's kernels
    launch);
  * :func:`tune` synthesizes operands for any registered ``cuda_op`` from
    planner shapes, times the top-k candidates (CUDA events around each
    launch on the card, warm-up then the median; a host timer on CPU
    tensors, which run the kernels' plain versions), and records the
    winner in a JSON cache keyed by the ``(op, shapes, dtype, machine)``
    cell — a schema-versioned, hash-stable key, so separate processes share
    winners and ``h100`` cells never mix with another machine's;
  * :func:`resolve` is the policy-aware schedule resolution every call
    site uses: ``"off"`` is the plain modeled argmin, ``"cache-only"``
    replays a cached winner (never times), ``"tune"`` measures on a miss
    and caches.

Cached winners are *rebuilt through the planner* (blocks and algorithm
pinned), so their model fields (loads/stores/vmem_bytes) stay exact and the
layers' ``fits()`` gating is untouched — a tuned schedule is just a
different point of the same enumeration.

Only a planner's rejection (:class:`~repro_torch.plan.planners.PlanRejected`)
degrades a cell to the modeled argmin; a kernel that fails to build or
launch while a candidate is timed raises.  A mesh-bound cell resolves
through the sharded planners (its key carries the mesh, the axis and a
strategy pin) and replays from the cache; timing a multi-device candidate
(the JAX package's per-device proxies and ``run_mesh``) waits for ROADMAP
queue 1 #5b and raises.

CLI: ``python -m repro_torch.plan.autotune --smoke [--device cpu]`` or
``--op matmul --shape m=256,n=4096,k=2048``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import inspect
import json
import os
import time
import warnings

import torch

from repro_torch.core.machine import H100, MachineModel
from repro_torch.plan.planners import PlanRejected, planner_for
from repro_torch.plan.schedule import Schedule
from repro_torch.plan.sharded import MeshSpec, ShardedSchedule, local_schedule, mesh_spec

# Bump to invalidate every cached winner (key derivation, record layout,
# or timing-protocol changes all warrant it).
SCHEMA_VERSION = 1

POLICIES = ("off", "cache-only", "tune")

_POLICY = os.environ.get("REPRO_AUTOTUNE", "off")
_CACHE_PATH: str | None = None  # None -> env / default, resolved lazily
_DEVICE = "cuda"  # where tune() synthesizes and times operands by default
_CACHES: dict[str, "AutotuneCache"] = {}
_TUNING = False  # reentrancy guard: never autotune inside a tuning run
_WARNED_CELLS: set[str] = set()  # cells whose degradation was already logged


def _warn_once(digest: str, message: str) -> None:
    """Warn about one cell's degradation path exactly once per process —
    the first fallback is loud, steady-state replays stay quiet."""
    if digest in _WARNED_CELLS:
        return
    _WARNED_CELLS.add(digest)
    warnings.warn(message, stacklevel=3)


def default_cache_path() -> str:
    return os.environ.get("REPRO_AUTOTUNE_CACHE") or os.path.join(
        os.path.expanduser("~"), ".cache", "repro_torch", "autotune.json")


def set_policy(policy: str, cache_path: str | None = None, device=None) -> None:
    """Set the process-wide autotune policy (and optionally the cache file
    and the device tuning measures on) — what ``launch/train.py
    --autotune`` calls.  Explicit ``autotune=`` arguments at call sites
    override the policy per call."""
    global _POLICY, _CACHE_PATH, _DEVICE
    if policy not in POLICIES:
        raise ValueError(f"autotune policy must be one of {POLICIES}, "
                         f"got {policy!r}")
    _POLICY = policy
    if cache_path is not None:
        _CACHE_PATH = cache_path
    if device is not None:
        _DEVICE = device


def get_policy() -> str:
    return _POLICY


def recovery_policy(policy: str | None = None) -> str:
    """The resolution policy for re-planning during failure recovery:
    never spend recovery time measuring — a session that autotunes
    ("tune"/"cache-only") resolves cache-only (a miss falls back to the
    planner's modeled argmin inside ``resolve``), while an "off" session
    stays off."""
    pol = policy if policy is not None else _POLICY
    if pol not in POLICIES:
        raise ValueError(f"autotune policy must be one of {POLICIES}, "
                         f"got {pol!r}")
    return "off" if pol == "off" else "cache-only"


def get_cache(path: str | None = None) -> "AutotuneCache":
    """The process-wide cache for ``path`` (default: the configured /
    env-derived location); one instance per file."""
    path = path or _CACHE_PATH or default_cache_path()
    if path not in _CACHES:
        _CACHES[path] = AutotuneCache(path)
    return _CACHES[path]


# ---------------------------------------------------------------------------
# Cache key: the (op, shapes, dtype, machine) cell
# ---------------------------------------------------------------------------


def _canonical_shape(shape: dict) -> list:
    """Sorted ``[name, value]`` pairs with unset (None) knobs dropped —
    two processes asking the same planner question hash identically."""
    return [[k, v] for k, v in sorted(shape.items()) if v is not None]


def _dtype_name(dtype) -> str:
    """"float32" for ``torch.float32``, ``np.float32`` or "float32"."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    import numpy as np

    return str(np.dtype(dtype))


def cache_key(
    op: str, shape: dict, dtype, machine: MachineModel,
    mesh: MeshSpec | None = None, axis: str = "model",
    strategy: str | None = None,
) -> tuple[str, str]:
    """``(readable, digest)`` for one autotuning cell.  ``readable`` is a
    canonical JSON encoding of ``(schema, op, shapes, dtype, machine,
    mesh, axis, strategy)``, laid out as the JAX package lays its own;
    ``digest`` is its sha256 — stable across processes and machines."""
    cell = [
        SCHEMA_VERSION, op, _canonical_shape(shape), _dtype_name(dtype),
        machine.name,
        None if mesh is None else [[a, int(s)] for a, s in mesh.axes],
        axis if mesh is not None else None,
        strategy,
    ]
    readable = json.dumps(cell, sort_keys=False, separators=(",", ":"))
    return readable, hashlib.sha256(readable.encode()).hexdigest()


class AutotuneCache:
    """Persistent JSON winner cache: ``{"schema": N, "entries": {digest:
    {"key": readable, "strategy": ..., "blocks": {...}, "us": ...}}}``.

    A corrupted or schema-mismatched file is treated as empty (the
    modeled argmin remains correct without it); writes are atomic
    (tmp + rename) and merge with the on-disk state so concurrent
    processes lose at most their own last winner."""

    def __init__(self, path: str):
        self.path = path
        self.generation = 0
        self._entries: dict[str, dict] | None = None
        self._memo: dict[str, Schedule | ShardedSchedule] = {}

    # -- persistence ------------------------------------------------------

    def _read_disk(self) -> dict[str, dict]:
        try:
            with open(self.path) as fh:
                data = json.load(fh)
            if not isinstance(data, dict) or data.get("schema") != SCHEMA_VERSION:
                return {}
            entries = data.get("entries")
            return entries if isinstance(entries, dict) else {}
        except FileNotFoundError:
            return {}
        except (json.JSONDecodeError, OSError, UnicodeDecodeError, ValueError) as e:
            warnings.warn(f"autotune cache {self.path!r} unreadable ({e}); "
                          "treating as empty", stacklevel=3)
            return {}

    def load(self) -> dict[str, dict]:
        if self._entries is None:
            self._entries = self._read_disk()
        return self._entries

    def reload(self) -> None:
        self._entries = None
        self._memo.clear()
        self.generation += 1

    # -- access -----------------------------------------------------------

    def get(self, digest: str) -> dict | None:
        return self.load().get(digest)

    def put(self, digest: str, readable: str, record: dict) -> None:
        entries = {**self._read_disk(), **self.load()}
        entries[digest] = {"key": readable, **record}
        self._entries = entries
        self._memo.clear()
        self.generation += 1
        os.makedirs(os.path.dirname(os.path.abspath(self.path)), exist_ok=True)
        tmp = f"{self.path}.tmp.{os.getpid()}"
        with open(tmp, "w") as fh:
            json.dump({"schema": SCHEMA_VERSION, "entries": entries}, fh,
                      indent=1, sort_keys=True)
        os.replace(tmp, self.path)

    def __len__(self) -> int:
        return len(self.load())


# ---------------------------------------------------------------------------
# Operand synthesis: planner shapes -> concrete tensors for timing
# ---------------------------------------------------------------------------


def _dtype_for(dtype, in_bytes) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    if dtype is not None:
        return getattr(torch, _dtype_name(dtype))
    return {2: torch.bfloat16, 8: torch.float64}.get(in_bytes, torch.float32)


def _conv_input_extent(out: int, F: int, S: int, P: int) -> int:
    return (out - 1) * S + F - 2 * P


def synthesize(op: str, shape: dict, dtype, device=None) -> tuple[tuple, dict]:
    """Concrete ``(tensors, call_params)`` for one op's planner shapes on
    ``device`` (default: the card) — what :func:`tune` times candidates
    on.  Contents come from a seeded ``torch.Generator`` on that device;
    only shapes and dtypes matter to the measurement."""
    device = torch.device(_DEVICE if device is None else device)
    gen = torch.Generator(device=device).manual_seed(0)
    dt = _dtype_for(dtype, shape.get("in_bytes"))

    def arr(*dims):
        return torch.randn(dims, generator=gen, device=device).to(dt)

    if op in ("conv2d", "conv2d_im2col", "conv2d_dgrad", "conv2d_wgrad"):
        F, S = shape["F"], shape.get("S", 1)
        P = shape.get("padding", shape.get("P", 0)) or 0
        B = shape.get("batch", 1)
        H_O, W_O = shape["H_O"], shape["W_O"]
        d_in, d_out = shape["d_in"], shape["d_out"]
        H_I = shape.get("H_I") or _conv_input_extent(H_O, F, S, P)
        W_I = shape.get("W_I") or _conv_input_extent(W_O, F, S, P)
        if op in ("conv2d", "conv2d_im2col"):
            pool = shape.get("pool", 1) or 1
            # The planner's H_O/W_O describe the pre-pool plane; the
            # traffic model stores pooled outputs, so time the fused form.
            return ((arr(B, H_I, W_I, d_in), arr(F, F, d_in, d_out), arr(d_out)),
                    dict(stride=S, padding=P, relu=pool > 1, pool=pool))
        if op == "conv2d_dgrad":
            pool = shape.get("pool")
            if pool:
                # Fused-epilogue cell: the kernel's real inputs are the
                # pooled cotangent plus the int8 mask residual (argmax
                # position in [0, pool^2], pool^2 = dead window).
                Hp, Wp = H_O // pool, W_O // pool
                mask = torch.randint(0, pool * pool + 1, (B, Hp, Wp, d_out),
                                     generator=gen, device=device).to(torch.int8)
                return ((arr(B, Hp, Wp, d_out), arr(F, F, d_in, d_out)),
                        dict(stride=S, padding=P, out_hw=(H_I, W_I),
                             mask=mask, pool=pool))
            return ((arr(B, H_O, W_O, d_out), arr(F, F, d_in, d_out)),
                    dict(stride=S, padding=P, out_hw=(H_I, W_I)))
        return ((arr(B, H_I, W_I, d_in), arr(B, H_O, W_O, d_out)),
                dict(F=F, stride=S, padding=P))

    if op in ("matmul", "matmul_dx", "matmul_dw"):
        m, n, k = shape["m"], shape["n"], shape["k"]
        if op == "matmul":
            return (arr(m, k), arr(k, n)), {}
        if op == "matmul_dx":  # dX = dY @ W^T
            return (arr(m, n), arr(k, n)), {}
        return (arr(m, k), arr(m, n)), {}  # dW = X^T @ dY

    if op == "flash_attention":
        B = shape.get("batch", 1)
        Hq, Hkv = shape.get("n_q_heads", 1), shape.get("n_kv_heads", 1)
        Sq, Skv, D = shape["seq_q"], shape["seq_kv"], shape["head_dim"]
        return ((arr(B, Hq, Sq, D), arr(B, Hkv, Skv, D), arr(B, Hkv, Skv, D)),
                dict(causal=shape.get("causal", True), window=shape.get("window")))

    raise KeyError(f"autotune has no operand synthesizer for op {op!r}")


# ---------------------------------------------------------------------------
# Timing
# ---------------------------------------------------------------------------


def _measure(fn, iters: int = 3, warmup: int = 1, *, device=None) -> float:
    """Median microseconds of ``fn`` after ``warmup`` calls (which also
    build the kernel): CUDA events around each call on the card, a host
    timer on the CPU."""
    cuda = device is not None and torch.device(device).type == "cuda"
    for _ in range(max(0, warmup)):
        fn()
    if cuda:
        torch.cuda.synchronize(device)
    ts = []
    for _ in range(max(1, iters)):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            ts.append(start.elapsed_time(end) * 1e3)
        else:
            t0 = time.perf_counter()
            fn()
            ts.append((time.perf_counter() - t0) * 1e6)
    ts.sort()
    return ts[len(ts) // 2]


def _label(cand) -> str:
    loc = local_schedule(cand)
    alg = getattr(loc, "algorithm", "direct")
    tag = f"{alg}:" if alg != "direct" else ""
    return f"{tag}{dict(loc.blocks)}"


# ---------------------------------------------------------------------------
# tune / lookup / resolve
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TuneReport:
    """One :func:`tune` outcome: the winning schedule, what was measured
    (``(label, us, modeled_words)`` rows, empty on a cache replay), and
    whether it came from the cache without timing."""

    key: str
    schedule: Schedule | ShardedSchedule
    measurements: tuple
    cached: bool


def _rebuild(op: str, shape: dict, rec: dict, machine: MachineModel, mesh,
             axis: str):
    """Reconstruct a cached winner through the planner: block pins and the
    algorithm tag re-planned so every model field is exact (not
    deserialized).  The tag is pinned wherever the planner takes one — a
    "direct" dgrad, wgrad or dX winner would otherwise replay as the
    planner's default variant (fused_epilogue, pipelined), which the JAX
    package's replay does."""
    blocks = {str(k): int(v) for k, v in rec.get("blocks", {}).items()}
    kwargs = {**shape, **blocks}
    planner = planner_for(op, machine, mesh, axis,
                          rec.get("strategy") if mesh is not None else None)
    alg = rec.get("algorithm")
    if alg and (alg != "direct"
                or "algorithm" in inspect.signature(planner.plan_local).parameters):
        kwargs["algorithm"] = str(alg)
    return planner.plan(**kwargs)


def tune(
    op, *, machine: MachineModel = H100, mesh=None, axis: str = "model",
    strategy: str | None = None, topk: int = 4, iters: int = 3, warmup: int = 1, dtype=None,
    cache: AutotuneCache | None = None, force: bool = False, device=None,
    **shape,
) -> TuneReport:
    """Measure the top-``topk`` candidate Schedules of one cell and cache
    the winner.

    ``op`` is a registered ``cuda_op`` name (or handle); ``**shape`` are
    its planner's keyword shapes (what ``CudaOp.shape_args`` produces).
    Candidates come from ``planner.candidates()`` ranked by modeled words;
    a cached winner short-circuits unless ``force=``.  Operands are
    synthesized on ``device`` (default: the process's tuning device, the
    card unless set).  Returns a :class:`TuneReport`.
    """
    global _TUNING
    from repro_torch.plan.registry import get_op

    opo = get_op(op) if isinstance(op, str) else op
    if cache is None:  # NB: an empty cache is falsy (len 0) but valid
        cache = get_cache()
    dt = _dtype_for(dtype, shape.get("in_bytes"))
    mesh = mesh_spec(mesh) if mesh is not None else None
    readable, digest = cache_key(opo.name, shape, dt, machine, mesh, axis, strategy)
    if not force:
        rec = cache.get(digest)
        if rec is not None:
            return TuneReport(
                key=digest,
                schedule=_rebuild(opo.name, shape, rec, machine, mesh, axis),
                measurements=tuple(tuple(m) for m in rec.get("measured", ())),
                cached=True)

    planner = planner_for(opo.name, machine, mesh, axis, strategy)
    cands = planner.candidates(**shape)[: max(1, topk)]
    if any(isinstance(c, ShardedSchedule) and c.devices > 1 for c in cands):
        raise NotImplementedError(
            f"timing {opo.name!r} candidates over {mesh.axes} (the per-device "
            "proxies) waits for ROADMAP queue 1 #5b; resolve mesh cells with "
            "policy 'off' or 'cache-only'")
    arrays, params = synthesize(opo.name, shape, dt, device)
    measured, timed = [], []
    _TUNING = True
    try:
        for c in cands:
            local = local_schedule(c)
            us = _measure(lambda: opo(*arrays, schedule=local, **params),
                          iters, warmup, device=arrays[0].device)
            measured.append((_label(c), us, c.modeled_words))
            timed.append((us, c))
    finally:
        _TUNING = False
    us, winner = min(timed, key=lambda t: t[0])
    record = {
        "op": opo.name,
        "strategy": winner.strategy if isinstance(winner, ShardedSchedule) else None,
        "algorithm": getattr(local_schedule(winner), "algorithm", "direct"),
        "blocks": dict(local_schedule(winner).blocks),
        "us": us,
        "modeled_words": winner.modeled_words,
        "measured": [list(m) for m in measured],
    }
    cache.put(digest, readable, record)
    return TuneReport(key=digest, schedule=winner, measurements=tuple(measured),
                      cached=False)


def lookup(
    op: str, shape: dict, *, machine: MachineModel = H100, mesh=None,
    axis: str = "model", strategy: str | None = None,
    cache: AutotuneCache | None = None, dtype=None,
) -> Schedule | ShardedSchedule | None:
    """The cached winner of one cell, rebuilt through the planner — or
    ``None`` on a miss.  Never times anything (``cache-only`` safe)."""
    if cache is None:  # NB: an empty cache is falsy (len 0) but valid
        cache = get_cache()
    dt = _dtype_for(dtype, shape.get("in_bytes"))
    mesh = mesh_spec(mesh) if mesh is not None else None
    readable, digest = cache_key(op, shape, dt, machine, mesh, axis, strategy)
    memo = cache._memo
    if digest in memo:
        return memo[digest]
    rec = cache.get(digest)
    if rec is None:
        return None
    try:
        sched = _rebuild(op, shape, rec, machine, mesh, axis)
    except PlanRejected as e:
        # Only a stale pin the planner now rejects degrades to the modeled
        # argmin, and says so once per cell with the full cell key.
        _warn_once(digest,
                   f"autotune cache entry for {op!r} unusable ({e}); "
                   f"cell {readable}; falling back to the modeled argmin")
        return None
    memo[digest] = sched
    return sched


def tuned_schedule(
    op: str, shape: dict, *, machine: MachineModel = H100, mesh=None,
    axis: str = "model", strategy: str | None = None, policy: str | None = None,
    cache: AutotuneCache | None = None, dtype=None, device=None,
) -> Schedule | ShardedSchedule | None:
    """The autotune override for one resolution, or ``None`` when the
    modeled argmin should stand: policy "off" (or reentrant tuning) is
    always ``None``; "cache-only" is lookup-only; "tune" measures on a
    miss.  Only the planner's rejection of the cell degrades (once per
    cell, with the cell key); a kernel error while timing, a missing
    synthesizer or a broken cache write re-raise."""
    pol = policy or _POLICY
    if pol == "off" or _TUNING:
        return None
    if pol not in POLICIES:
        raise ValueError(f"autotune policy must be one of {POLICIES}, "
                         f"got {pol!r}")
    got = lookup(op, shape, machine=machine, mesh=mesh, axis=axis, strategy=strategy,
                 cache=cache, dtype=dtype)
    if got is not None or pol == "cache-only":
        return got
    try:
        return tune(op, machine=machine, mesh=mesh, axis=axis, strategy=strategy,
                    cache=cache, dtype=dtype, device=device, **shape).schedule
    except PlanRejected as e:
        dt = _dtype_for(dtype, shape.get("in_bytes"))
        ms = mesh_spec(mesh) if mesh is not None else None
        readable, digest = cache_key(op, shape, dt, machine, ms, axis, strategy)
        _warn_once(digest,
                   f"autotuning {op!r} failed ({e}); cell {readable}; "
                   "falling back to the modeled argmin")
        return None


def resolve(
    op: str, shape: dict, *, machine: MachineModel = H100, mesh=None,
    axis: str = "model", strategy: str | None = None, policy: str | None = None,
    cache: AutotuneCache | None = None, dtype=None, device=None,
) -> Schedule | ShardedSchedule:
    """Policy-aware schedule resolution (what every ``plan`` helper and
    the op registry route through): a cached/measured winner when the
    policy provides one, else the planner's modeled argmin."""
    got = tuned_schedule(op, shape, machine=machine, mesh=mesh, axis=axis,
                         strategy=strategy, policy=policy, cache=cache, dtype=dtype,
                         device=device)
    if got is not None:
        return got
    return planner_for(op, machine, mesh, axis, strategy).plan(**shape)


def warm(
    cells: dict, *, machine: MachineModel = H100, mesh=None, axis: str = "model",
    policy: str | None = None, cache: AutotuneCache | None = None, dtype=None,
    device=None,
) -> tuple[dict, dict]:
    """Boot-time resolution of a *named set* of cells (the serving path
    resolves every bucket's cells here once, so the request path never
    plans or times a new shape).

    ``cells`` maps ``name -> (op_name, planner_shape)``.  Returns
    ``(plans, sources)``: the resolved Schedule per name, and each cell's
    provenance — ``"cached"`` (replayed without timing), ``"tuned"``
    (measured this boot under policy "tune"), or ``"modeled"`` (the
    planner's argmin: policy "off", a cache-only miss, or a rejected
    cell)."""
    pol = policy or _POLICY
    if pol not in POLICIES:
        raise ValueError(f"autotune policy must be one of {POLICIES}, "
                         f"got {pol!r}")
    plans: dict = {}
    sources: dict[str, str] = {}
    for name, (op, shape) in cells.items():
        def _hit():
            return lookup(op, shape, machine=machine, mesh=mesh, axis=axis,
                          cache=cache, dtype=dtype) is not None

        pre = pol != "off" and _hit()
        plans[name] = resolve(op, shape, machine=machine, mesh=mesh, axis=axis,
                              policy=pol, cache=cache, dtype=dtype, device=device)
        if pre:
            sources[name] = "cached"
        elif pol == "tune" and _hit():
            sources[name] = "tuned"
        else:
            sources[name] = "modeled"
    return plans, sources


# ---------------------------------------------------------------------------
# CLI: the tune-then-replay smoke and ad-hoc cell tuning
# ---------------------------------------------------------------------------


def _smoke(device) -> int:
    """Tune one tiny conv cell, one FC cell and one fused-epilogue dgrad
    cell (pooled cotangent + mask residual) on the H100 model's blocks,
    then assert each winner replays from the cache — and that the conv
    cell's candidates span both algorithm families of the two-level
    argmin, whose tag survives the replay.  (The JAX package also tunes a
    MANTICORE cell; its one-channel blocks are not blocks the port's
    kernels, or their plain versions, take.)  A configured cache
    ($REPRO_AUTOTUNE_CACHE or --cache) is honored, else a throwaway one;
    never the default user cache."""
    import tempfile

    if _CACHE_PATH or os.environ.get("REPRO_AUTOTUNE_CACHE"):
        cache = get_cache()
    else:
        cache = AutotuneCache(os.path.join(tempfile.mkdtemp(), "autotune.json"))
    cells = [
        ("conv2d", dict(H_O=8, W_O=8, F=3, S=1, d_in=8, d_out=16, in_bytes=4,
                        padding=1, batch=2, pool=2)),
        ("matmul", dict(m=16, n=256, k=64, in_bytes=4)),
        ("conv2d_dgrad", dict(H_O=8, W_O=8, F=3, S=1, P=1, d_in=8, d_out=16,
                              in_bytes=4, batch=2, pool=2)),
    ]
    print("op,us,cached,blocks")
    for op, shape in cells:
        first = tune(op, topk=6, iters=1, warmup=1, cache=cache, force=True,
                     device=device, **shape)
        replay = tune(op, topk=6, iters=1, warmup=1, cache=cache, device=device, **shape)
        assert not first.cached and replay.cached, (
            f"{op}: expected tune-then-replay, got cached="
            f"{first.cached},{replay.cached}")
        a, b = local_schedule(first.schedule), local_schedule(replay.schedule)
        assert (a.algorithm, a.blocks, a.grid) == (b.algorithm, b.blocks, b.grid), (
            f"{op}: cache replay diverged: {a} vs {b}")
        for label, us, words in first.measurements:
            print(f"{op}:{label},{us:.1f},False,words={words}")
        print(f"{op}:winner,{b.algorithm}:{dict(b.blocks)},True,replayed_from={cache.path}")
        if op == "conv2d":
            labels = [m[0] for m in first.measurements]
            assert any(lbl.startswith("im2col:") for lbl in labels) and any(
                not lbl.startswith("im2col:") for lbl in labels), (
                f"conv2d: expected candidates from both algorithm families, got {labels}")
    print(f"autotune smoke ok ({len(cache)} cached cells)")
    return 0


def main(argv=None) -> int:
    import argparse

    from repro_torch.core.machine import MACHINES

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="tiny conv + fc + dgrad tune against the configured "
                         "cache; assert the winners replay")
    ap.add_argument("--op", default=None, help="registered cuda_op name")
    ap.add_argument("--shape", default="",
                    help="comma-separated planner shapes, e.g. m=256,n=4096,k=2048")
    ap.add_argument("--machine", default="h100", choices=sorted(MACHINES))
    ap.add_argument("--topk", type=int, default=4)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--warmup", type=int, default=1)
    ap.add_argument("--cache", default=None, help="cache file override")
    ap.add_argument("--force", action="store_true", help="re-measure")
    ap.add_argument("--device", default="cuda",
                    help="where to time (default: the card; cpu runs the "
                         "kernels' plain versions)")
    args = ap.parse_args(argv)

    if args.cache:
        set_policy(_POLICY if _POLICY in POLICIES else "off", args.cache)
    if args.smoke:
        return _smoke(args.device)
    if not args.op:
        ap.error("--op (or --smoke) required")
    shape = {}
    for tok in filter(None, args.shape.split(",")):
        k, _, v = tok.partition("=")
        shape[k.strip()] = int(v)
    rep = tune(args.op, machine=MACHINES[args.machine], topk=args.topk,
               iters=args.iters, warmup=args.warmup, force=args.force,
               device=args.device, **shape)
    print(f"cell {rep.key[:16]} cached={rep.cached}")
    for label, us, words in rep.measurements:
        print(f"  {label}: {us:.1f}us modeled_words={words}")
    print(f"winner {dict(local_schedule(rep.schedule).blocks)} -> {get_cache().path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
