"""Carry the JAX package's parameters across to the port.

``repro``'s ``init_params`` output, as numpy arrays, keeps its layouts here
unchanged (NHWC activations, ``[F, F, D_I, D_O]`` filters, ``[K, N]`` FC
weights), so both packages compute the same function on the same weights.
"""

from __future__ import annotations

import numpy as np
import torch


def params_from_repro(np_params: dict, *, device=None) -> dict[str, torch.Tensor]:
    """{name: array} -> {name: tensor} on ``device`` (default: the card),
    same shapes, same layouts, same dtype."""
    device = torch.device("cuda" if device is None else device)
    return {name: torch.from_numpy(np.array(value, copy=True)).to(device)
            for name, value in np_params.items()}
