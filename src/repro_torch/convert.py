"""Carry the JAX package's parameters across to the port.

``repro``'s ``init_params`` output, as numpy arrays, keeps its layouts here
unchanged (NHWC activations, ``[F, F, D_I, D_O]`` filters, ``[K, N]`` FC
weights, stacked ``[L, ...]`` transformer layers), so both packages compute
the same function on the same weights.  A nested tree flattens into the
port's ``"a/b/c"`` paths, the path ``repro`` seeds each leaf by.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch


def flatten_tree(tree: Mapping, prefix: str = "") -> dict:
    """{"layers": {"attn": {"wq": x}}} -> {"layers/attn/wq": x}."""
    out = {}
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else key
        if isinstance(value, Mapping):
            out.update(flatten_tree(value, path))
        else:
            out[path] = value
    return out


def params_from_repro(np_params: Mapping, *, device=None) -> dict[str, torch.Tensor]:
    """{name: array}, nested or flat -> {path: tensor} on ``device``
    (default: the card), same shapes, same layouts, same dtype."""
    device = torch.device("cuda" if device is None else device)
    return {path: torch.from_numpy(np.array(value, copy=True)).to(device)
            for path, value in flatten_tree(np_params).items()}
