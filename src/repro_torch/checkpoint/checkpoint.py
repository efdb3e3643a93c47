"""Fault-tolerant checkpointing, on the JAX package's on-disk layout.

Layout (one directory per step, atomic via tmp-dir + rename + COMMIT marker):

    ckpt/step_0000012/
      index.json              tree structure + per-leaf chunk table
      <leaf>.c00.npy ...      chunks split along axis 0
      COMMIT                  written last; restore ignores dirs without it

The layout is ``repro.checkpoint``'s byte for byte: the same leaf names
(``params/<path>``, ``opt/step``, ``opt/m/<path>``, ``opt/v/<path>``,
``err/<path>`` for a ``TrainState``), the same file names, the same
``index.json`` and the same ``.npy`` bytes (bf16 stored as ``u2`` bits), so a
checkpoint written by either package restores into the other.  ``restore``
takes a ``device`` where ``repro`` takes shardings, and ``specs`` and a
``mesh`` for a sharded state: each rank then reads only its piece of each
leaf, from the chunks along axis 0 that overlap it (reshard-on-restore: a
checkpoint written on one mesh restores onto any other).  A sharded state
is saved whole: :func:`gather_state` puts its leaves together on every
rank, and one rank writes the layout above.

Integrity: every chunk's sha256 (of the on-disk ``.npy`` bytes) is recorded
in ``index.json`` and re-checked on restore, so a torn write surfaces as
:class:`CheckpointCorruptError` instead of silently restoring garbage —
:func:`restore_latest` then falls back to the previous committed step
(logged, never silent).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import re
import shutil
import threading
import warnings
from collections.abc import Mapping

import numpy as np
import torch

_SAFE = re.compile(r"[^A-Za-z0-9_.-]")


class CheckpointError(RuntimeError):
    """Base class for checkpoint failures."""


class CheckpointCorruptError(CheckpointError):
    """A chunk file is missing, torn, or fails its sha256 digest."""


class CheckpointMismatchError(CheckpointError):
    """The checkpoint's tree doesn't match the tree being restored (missing
    leaf or shape mismatch) — unlike a bare ``assert`` this survives
    ``python -O``."""


def _sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def _leaf_paths(tree, prefix: str = "") -> list[tuple[str, object]]:
    """``[(path, leaf)]`` in ``repro``'s flattening order: dataclass fields
    in declaration order, dict keys sorted (a flat ``"a/b/c"`` key sorts as
    its nested path), ``None`` as no leaf."""
    if tree is None:
        return []
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        items = [(f.name, getattr(tree, f.name)) for f in dataclasses.fields(tree)]
    elif isinstance(tree, Mapping):
        items = sorted(tree.items(), key=lambda kv: tuple(str(kv[0]).split("/")))
    else:
        return [(prefix, tree)]
    out = []
    for key, value in items:
        out.extend(_leaf_paths(value, f"{prefix}/{key}" if prefix else str(key)))
    return out


def _rebuild(template, values: dict, prefix: str = ""):
    """``template``'s structure with each leaf replaced by ``values[path]``."""
    if template is None:
        return None
    if dataclasses.is_dataclass(template) and not isinstance(template, type):
        return dataclasses.replace(template, **{
            f.name: _rebuild(getattr(template, f.name), values,
                             f"{prefix}/{f.name}" if prefix else f.name)
            for f in dataclasses.fields(template)})
    if isinstance(template, Mapping):
        return {k: _rebuild(v, values, f"{prefix}/{k}" if prefix else str(k))
                for k, v in template.items()}
    return values[prefix]


def _fname(leaf_path: str, chunk: int) -> str:
    return f"{_SAFE.sub('_', leaf_path)}.c{chunk:02d}.npy"


def _dtype_name(dtype) -> str:
    return str(dtype).removeprefix("torch.") if isinstance(dtype, torch.dtype) \
        else np.dtype(dtype).name


def _to_numpy(leaf) -> tuple[np.ndarray, str]:
    """(host array, logical dtype name) of one leaf: a tensor, an array, or
    a Python int (the optimizer's step, stored as a 0-d int32 as ``repro``
    stores its int32 scalar)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        name = _dtype_name(t.dtype)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), name
        return t.numpy(), name
    if isinstance(leaf, int):
        return np.asarray(leaf, np.int32), "int32"
    arr = np.asarray(leaf)
    return arr, arr.dtype.name


def _host(leaf):
    """A host copy of one leaf, keeping its logical dtype."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return leaf if isinstance(leaf, int) else np.array(leaf, copy=True)


def save(ckpt_dir: str, step: int, tree, n_chunks: int = 1) -> str:
    """Write a checkpoint; returns the final directory path."""
    final = os.path.join(ckpt_dir, f"step_{step:07d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)

    index = {"step": step, "leaves": {}}
    for path, leaf in _leaf_paths(tree):
        arr, logical_dtype = _to_numpy(leaf)
        bits = arr.dtype.kind not in "fiub" or logical_dtype == "bfloat16"
        if bits and arr.dtype.kind != "u":
            arr = arr.view(np.dtype(f"u{arr.dtype.itemsize}"))
        chunks = []
        n = max(1, min(n_chunks, arr.shape[0] if arr.ndim else 1))
        splits = np.array_split(np.arange(arr.shape[0] if arr.ndim else 1), n)
        off = 0
        for ci, idx in enumerate(splits):
            if arr.ndim:
                part = arr[idx[0]: idx[-1] + 1] if len(idx) else arr[0:0]
            else:
                part = arr
            fn = _fname(path, ci)
            np.save(os.path.join(tmp, fn), part)
            chunks.append({"file": fn, "offset": off,
                           "rows": int(len(idx)) if arr.ndim else 1,
                           "sha256": _sha256_file(os.path.join(tmp, fn))})
            off += len(idx) if arr.ndim else 1
        index["leaves"][path] = {
            "shape": list(arr.shape),
            "dtype": logical_dtype,
            "bits": bits,
            "chunks": chunks,
        }

    with open(os.path.join(tmp, "index.json"), "w") as f:
        json.dump(index, f)
    with open(os.path.join(tmp, "COMMIT"), "w") as f:
        f.write("ok")
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


@dataclasses.dataclass
class AsyncSave:
    """Handle for a background save.  ``join()`` re-raises anything the
    writer thread hit (a silently-dropped IO error here means the next
    restore finds no checkpoint where the trainer believes one exists)."""

    step: int
    _thread: threading.Thread
    _exc: list = dataclasses.field(default_factory=list)
    path: str | None = None

    def join(self, timeout: float | None = None) -> str | None:
        self._thread.join(timeout)
        if self._thread.is_alive():
            raise TimeoutError(f"save of step {self.step} still running")
        if self._exc:
            raise self._exc[0]
        return self.path

    def is_alive(self) -> bool:
        return self._thread.is_alive()


def save_async(ckpt_dir: str, step: int, tree, n_chunks: int = 1) -> AsyncSave:
    """Copy every leaf to the host on the caller thread (the device copy-out,
    which also orders the save after the step that made the state), file IO
    on a background thread.  The returned handle's ``join()`` re-raises
    background failures instead of swallowing them."""
    values = {path: _host(leaf) for path, leaf in _leaf_paths(tree)}
    host_tree = _rebuild(tree, values)
    handle = AsyncSave(step=step, _thread=None)  # type: ignore[arg-type]

    def _run():
        try:
            handle.path = save(ckpt_dir, step, host_tree, n_chunks)
        except BaseException as e:  # re-raised from join()
            handle._exc.append(e)

    t = threading.Thread(target=_run, daemon=True)
    handle._thread = t
    t.start()
    return handle


def _committed(ckpt_dir: str, d: str) -> bool:
    """A step dir counts only if COMMIT exists AND index.json parses — a
    COMMIT with an unreadable index must not be offered as the resume
    point."""
    if not os.path.exists(os.path.join(ckpt_dir, d, "COMMIT")):
        return False
    try:
        with open(os.path.join(ckpt_dir, d, "index.json")) as f:
            json.load(f)
        return True
    except (OSError, json.JSONDecodeError):
        return False


def committed_steps(ckpt_dir: str) -> list[int]:
    """All restorable steps, ascending (COMMIT present, index readable)."""
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(
        int(m.group(1))
        for d in os.listdir(ckpt_dir)
        if (m := re.fullmatch(r"step_(\d+)", d)) and _committed(ckpt_dir, d)
    )


def latest_step(ckpt_dir: str) -> int | None:
    steps = committed_steps(ckpt_dir)
    return steps[-1] if steps else None


def _read_leaf(step_dir: str, meta: dict, index: tuple | None = None) -> np.ndarray:
    """One leaf reassembled from its row chunks, as stored (bits views
    stay unsigned); with ``index`` (a slice per dimension) only that piece,
    read from the chunks whose rows overlap it."""
    chunks = sorted(meta["chunks"], key=lambda ch: ch["offset"])
    if not meta["shape"]:  # scalar
        return np.array(np.load(os.path.join(step_dir, chunks[0]["file"])))
    index = index or (slice(None),) * len(meta["shape"])
    start, stop, _ = index[0].indices(meta["shape"][0])
    parts = []
    for ch in chunks:
        off, rows = ch["offset"], ch["rows"]
        lo, hi = max(start, off), min(stop, off + rows)
        if lo < hi:
            mm = np.load(os.path.join(step_dir, ch["file"]), mmap_mode="r")
            parts.append(np.array(mm[lo - off:hi - off][(slice(None),) + tuple(index[1:])]))
    return np.concatenate(parts, 0) if len(parts) != 1 else parts[0]


def _as_leaf(arr: np.ndarray, meta: dict, like, device):
    """A stored array as the template leaf's kind: a tensor of ``like``'s
    dtype on ``device``, or a Python int for an int template."""
    if isinstance(like, int):
        return int(arr)
    if meta.get("bits", False):
        arr = arr.view(np.dtype(f"i{arr.dtype.itemsize}"))
        t = torch.from_numpy(arr).view(like.dtype)
    else:
        t = torch.from_numpy(arr).to(like.dtype)
    return t.to(device)


def verify_step(ckpt_dir: str, step: int) -> None:
    """Check every chunk of a committed step against its recorded sha256.
    Raises :class:`CheckpointCorruptError` on a missing/torn/corrupt chunk
    (chunks written before digests existed are skipped)."""
    step_dir = os.path.join(ckpt_dir, f"step_{step:07d}")
    try:
        with open(os.path.join(step_dir, "index.json")) as f:
            index = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        raise CheckpointCorruptError(f"step {step}: unreadable index.json ({e})")
    for path, meta in index["leaves"].items():
        for ch in meta["chunks"]:
            fpath = os.path.join(step_dir, ch["file"])
            if not os.path.exists(fpath):
                raise CheckpointCorruptError(
                    f"step {step}: leaf {path!r} chunk {ch['file']} missing")
            want = ch.get("sha256")
            if want is None:
                continue  # pre-digest checkpoint
            got = _sha256_file(fpath)
            if got != want:
                raise CheckpointCorruptError(
                    f"step {step}: leaf {path!r} chunk {ch['file']} failed "
                    f"sha256 verification (torn or corrupt write): "
                    f"recorded {want[:12]}…, found {got[:12]}…")


def gather_state(tree, specs, mesh):
    """A sharded tree put together: each tensor leaf gathered whole over
    the axes its spec in ``specs`` (a tree of the same structure, ``P``
    leaves) names, on every rank of ``mesh`` (a collective: every rank
    calls it)."""
    from repro_torch.runtime.parallel import gather_tensor

    spec_of = dict(_leaf_paths(specs))
    return _rebuild(tree, {
        path: gather_tensor(leaf, spec_of[path], mesh)
        if isinstance(leaf, torch.Tensor) and spec_of.get(path) else leaf
        for path, leaf in _leaf_paths(tree)})


def restore(ckpt_dir: str, step: int, template, device=None, verify: bool = True, *,
            specs=None, mesh=None):
    """Restore onto ``template``'s structure: a tree of tensors (only their
    shapes and dtypes are read; ``meta`` tensors do) and Python ints.  Each
    tensor leaf comes back on ``device`` (default: the card) in its
    template's dtype; an int leaf comes back as an int.  With ``specs``
    (a tree of ``P`` of the template's structure) and ``mesh``, each tensor
    leaf comes back as this rank's piece under its spec, read from the
    chunks that overlap it.  ``verify`` (default) checks every chunk's
    sha256 first, so a torn write raises :class:`CheckpointCorruptError`
    up front."""
    from repro_torch.runtime.parallel import local_index

    device = torch.device("cuda" if device is None else device)
    spec_of = dict(_leaf_paths(specs)) if specs is not None else {}
    step_dir = os.path.join(ckpt_dir, f"step_{step:07d}")
    if verify:
        verify_step(ckpt_dir, step)
    with open(os.path.join(step_dir, "index.json")) as f:
        index = json.load(f)

    leaves_meta = index["leaves"]
    out = {}
    for path, like in _leaf_paths(template):
        if path not in leaves_meta:
            raise CheckpointMismatchError(
                f"step {step}: leaf {path!r} not in checkpoint "
                f"(has {sorted(leaves_meta)[:8]}…)")
        meta = leaves_meta[path]
        shape = () if isinstance(like, int) else tuple(like.shape)
        if tuple(meta["shape"]) != shape:
            raise CheckpointMismatchError(
                f"step {step}: leaf {path!r} shape mismatch — checkpoint "
                f"holds {tuple(meta['shape'])}, restore target expects "
                f"{shape}")
        spec = spec_of.get(path)
        index = local_index(shape, spec, mesh) if spec and shape else None
        out[path] = _as_leaf(_read_leaf(step_dir, meta, index), meta, like, device)
    return _rebuild(template, out)


def restore_latest(ckpt_dir: str, template, device=None, verify: bool = True, *,
                   specs=None, mesh=None):
    """Restore the newest *intact* committed step: integrity failures on
    the latest step fall back to the previous committed one (and so on),
    each fallback logged via ``warnings.warn``.  Returns ``(tree, step)``
    or ``(None, None)`` when no restorable checkpoint exists.  Mismatch
    errors (wrong tree shape) are NOT absorbed: older steps would mismatch
    identically, and masking them would hide a real caller bug."""
    for step in reversed(committed_steps(ckpt_dir)):
        try:
            return restore(ckpt_dir, step, template, device, verify=verify, specs=specs,
                           mesh=mesh), step
        except (CheckpointCorruptError, OSError, json.JSONDecodeError) as e:
            warnings.warn(
                f"checkpoint step {step} in {ckpt_dir} is corrupt "
                f"({e}); falling back to the previous committed step",
                stacklevel=2)
    return None, None


def retain(ckpt_dir: str, keep: int = 3) -> None:
    if not os.path.isdir(ckpt_dir):
        return
    steps = sorted(
        int(m.group(1))
        for d in os.listdir(ckpt_dir)
        if (m := re.fullmatch(r"step_(\d+)", d))
    )
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:07d}"), ignore_errors=True)
