"""Model-family registry: family name -> module implementing the family
protocol (``param_defs`` / ``forward``) and the hooks a trainer dispatches
on (``data_source``, ``make_loss_fn``, ``plan_training``) — no family
branching at the call sites.  The port has the cnn family and the dense
transformer (also registered as ``transformer``, the planned wing's name)."""

from __future__ import annotations

from repro_torch.models import cnn, transformer

FAMILIES = {
    "dense": transformer,
    "transformer": transformer,  # the planned wing's first-class name
    "cnn": cnn,
}


def get_family(name: str):
    try:
        return FAMILIES[name]
    except KeyError:
        raise ValueError(f"unknown model family {name!r}; have {list(FAMILIES)}") from None


def make_data_source(cfg, batch: int, seq: int, shard, seed: int = 0):
    """The family's synthetic data source: its ``data_source(cfg, batch,
    shard, seed=)`` hook (the cnn's image batches), else the token-stream
    default (``SyntheticSource`` over ``cfg.vocab``, where ``seq``
    applies)."""
    hook = getattr(get_family(cfg.family), "data_source", None)
    if hook is not None:
        return hook(cfg, batch, shard, seed=seed)
    from repro_torch.data.pipeline import SyntheticSource

    return SyntheticSource(cfg.vocab, seq, batch, shard, seed=seed)
