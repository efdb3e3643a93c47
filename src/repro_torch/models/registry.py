"""Model-family registry: family name -> module implementing the family
protocol (``param_defs`` / ``forward`` / ``logits``) and the hooks the
trainer and the server dispatch on (``data_source``, ``make_loss_fn``,
``plan_training``, ``batch_shard_specs``, ``init_cache``,
``slot_decode_kwargs``) — no family
branching at the call sites.  The port has every family of the JAX
package's registry: the cnn, the dense transformer (also registered as
``transformer``, the planned wing's name), the MoE, RWKV-6, Zamba2 and
the encoder-decoder.  A family without ``make_loss_fn`` trains on the
generic chunked-CE loss (``runtime.train.make_loss_fn``); one with
``init_cache`` (every token family) can be served."""

from __future__ import annotations

from repro_torch.models import cnn, encdec, moe, rwkv6, transformer, zamba2
from repro_torch.plan.sharded import P

FAMILIES = {
    "dense": transformer,
    "transformer": transformer,  # the planned wing's first-class name
    "moe": moe,
    "rwkv6": rwkv6,
    "zamba2": zamba2,
    "encdec": encdec,
    "cnn": cnn,
}


def get_family(name: str):
    try:
        return FAMILIES[name]
    except KeyError:
        raise ValueError(f"unknown model family {name!r}; have {list(FAMILIES)}") from None


def init_cache_slots(cfg, n_slots: int, max_seq: int, dtype, *, device=None):
    """Allocate the serving engine's decode-state slot pool: the family's
    ``init_cache`` with one batch row per slot, on ``device`` (default: the
    card).  Every cache leaf has the slot axis at axis 1 (``[L, B, ...]``),
    which the engine's slot scatter relies on.  A family without the hook
    (cnn) cannot be served and raises."""
    hook = getattr(FAMILIES.get(cfg.family), "init_cache", None)
    if hook is None:
        raise ValueError(
            f"model family {cfg.family!r} has no init_cache hook; it cannot "
            "be served through repro_torch.serve (no decode state to slot)")
    return hook(cfg, n_slots, max_seq, dtype, device=device)


def batch_shard_specs(cfg, dp) -> dict:
    """The family's batch sharding specs over the data axes ``dp`` (an axis
    name or tuple): its ``batch_shard_specs(dp)`` hook (the cnn's images
    shard their batch dim, matching the sharded ConvPlanner's "batch"
    partition), else the token families' default."""
    hook = getattr(FAMILIES.get(cfg.family), "batch_shard_specs", None)
    if hook is not None:
        return hook(dp)
    return {k: P(dp, None) for k in ("tokens", "labels")}


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
