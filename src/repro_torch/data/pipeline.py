"""Deterministic, shard-aware synthetic data for the port's trainer.

``SyntheticImageSource`` makes CIFAR-shaped image/label batches for the cnn
family from (seed, step, shard) with numpy, exactly as the JAX package's
source does, so both packages train on bit-identical batches.  It yields
{"images": [B_local, IMG, IMG, C] float32, "labels": [B_local] int32} as
numpy arrays; the trainer moves them to its device.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class ShardInfo:
    index: int  # this host's shard index
    count: int  # number of data shards


class SyntheticImageSource:
    """Deterministic image/label batches for the cnn family: class-coded
    blobs on noise, so the training loss can actually fall."""

    def __init__(self, img: int, channels: int, classes: int,
                 global_batch: int, shard: ShardInfo = ShardInfo(0, 1),
                 seed: int = 0):
        assert global_batch % shard.count == 0
        self.img, self.channels, self.classes = img, channels, classes
        self.batch = global_batch // shard.count
        self.shard, self.seed = shard, seed

    def __call__(self, step: int) -> dict:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.shard.index])
        )
        labels = rng.integers(0, self.classes, size=(self.batch,)).astype(np.int32)
        images = rng.standard_normal(
            (self.batch, self.img, self.img, self.channels)).astype(np.float32)
        # A learnable class signal: shift each image's mean by its label.
        images += (labels / max(1, self.classes - 1) - 0.5)[:, None, None, None]
        return {"images": images, "labels": labels}
