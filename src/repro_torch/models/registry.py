"""Model-family registry: family name -> module implementing the family
protocol (``param_defs`` / ``forward``) and the hooks a trainer dispatches
on (``data_source``, ``make_loss_fn``, ``plan_training``) — no family
branching at the call sites.  The port has the cnn family so far."""

from __future__ import annotations

from repro_torch.models import cnn

FAMILIES = {"cnn": cnn}


def get_family(name: str):
    try:
        return FAMILIES[name]
    except KeyError:
        raise ValueError(f"unknown model family {name!r}; have {list(FAMILIES)}") from None


def make_data_source(cfg, batch: int, shard, seed: int = 0):
    """The family's synthetic data source (its ``data_source`` hook)."""
    return get_family(cfg.family).data_source(cfg, batch, shard, seed=seed)
