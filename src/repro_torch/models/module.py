"""Parameter definitions and their seeded initialization.

A model family provides ``param_defs(cfg) -> dict of ParamDef``; from the
defs, :func:`init_params` materializes the weights.  Every leaf draws from
its own numpy generator, seeded by the caller's seed and a hash of the
leaf's path, so initialization is order- and structure-stable.  (The two
packages' generators differ, so tests carry the JAX package's weights
across with ``repro_torch.convert`` instead.)  The leaves draw on a pool of
threads (numpy's generators release the GIL), each from its own generator,
so the values do not depend on the thread count.
"""

from __future__ import annotations

import dataclasses
import math
import os
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Any

import numpy as np
import torch

from repro_torch.plan.sharded import P


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: tuple[int, ...]
    # Partition-spec entries: None | axis name | tuple of axis names.
    spec: tuple = ()
    init: str = "normal"  # normal | zeros | ones
    scale: float | None = None  # stddev; default 1/sqrt(fan_in)
    dtype: Any = None  # None -> the model's param dtype
    fan_in_axis: int = -2  # which axis is fan-in for default init scale

    def partition_spec(self) -> P:
        spec = self.spec or (None,) * len(self.shape)
        if len(spec) != len(self.shape):
            raise ValueError(f"spec {spec} does not match shape {self.shape}")
        return P(*spec)


def _draw(path: str, d: ParamDef, seed: int) -> np.ndarray:
    """One normal leaf: N(0, scale) from the leaf's own generator."""
    rng = np.random.default_rng([seed, zlib.crc32(path.encode())])
    fan_in = d.shape[d.fan_in_axis] if len(d.shape) >= 2 else d.shape[-1]
    scale = d.scale if d.scale is not None else 1.0 / math.sqrt(max(fan_in, 1))
    w = rng.standard_normal(d.shape, dtype=np.float32)
    w *= np.float32(scale)
    return w


def init_params(defs: dict, seed: int, *, device=None,
                dtype: torch.dtype = torch.float32) -> dict:
    """Materialize parameters on ``device`` (default: the card)."""
    device = torch.device("cuda" if device is None else device)
    normal = [p for p, d in defs.items() if d.init not in ("zeros", "ones")]
    workers = max(1, min(len(normal), os.cpu_count() or 1))
    out = {}
    with ThreadPoolExecutor(workers) as pool:
        drawn = dict(zip(normal, pool.map(lambda p: _draw(p, defs[p], seed), normal)))
        for path, d in defs.items():
            dt = d.dtype or dtype
            if d.init in ("zeros", "ones"):
                fill = torch.zeros if d.init == "zeros" else torch.ones
                out[path] = fill(d.shape, dtype=dt, device=device)
            else:
                out[path] = torch.from_numpy(drawn.pop(path)).to(device=device, dtype=dt)
    return out


def count_params(defs: dict) -> int:
    return sum(math.prod(d.shape) for d in defs.values())


def abstract_params(defs: dict, dtype: torch.dtype = torch.float32) -> dict:
    """``{path: tensor}`` of each leaf's shape and dtype on the ``meta``
    device: nothing is allocated."""
    return {path: torch.empty(d.shape, dtype=d.dtype or dtype, device="meta")
            for path, d in defs.items()}


def param_specs(defs: dict) -> dict:
    """``{path: P}``: each leaf's partition spec."""
    return {path: d.partition_spec() for path, d in defs.items()}


def flatten_defs(defs: dict):
    """Yield (path, ParamDef) pairs (the defs are flat already)."""
    yield from defs.items()


def prefixed(prefix: str, defs: dict) -> dict:
    """``{"wq": d}`` -> ``{"<prefix>/wq": d}``: a sub-tree's flat paths
    under a parent key."""
    return {f"{prefix}/{k}": v for k, v in defs.items()}


def nest(flat: dict) -> dict:
    """``{"attn/wq": x}`` -> ``{"attn": {"wq": x}}``."""
    out: dict = {}
    for path, value in flat.items():
        *parents, leaf = path.split("/")
        node = out
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    return out


def subtree(params: dict, prefix: str) -> dict:
    """The nested tree of the flat paths under ``prefix``."""
    head = prefix + "/"
    return nest({k[len(head):]: v for k, v in params.items() if k.startswith(head)})


def unstack(params: dict, prefix: str, n: int) -> list[dict]:
    """Per-layer nested trees of the stacked ``[n, ...]`` leaves under
    ``prefix``, each stack unbound once (so autograd stacks each gradient
    once)."""
    head = prefix + "/"
    rows = {k[len(head):]: v.unbind(0) for k, v in params.items() if k.startswith(head)}
    return [nest({k: r[i] for k, r in rows.items()}) for i in range(n)]
