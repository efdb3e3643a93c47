"""Deterministic, shard-aware data for the port's trainer.

The synthetic sources draw from (seed, step, shard) with numpy, exactly as
the JAX package's do, so both packages train on bit-identical batches:

* ``SyntheticSource`` — structured pseudo-text (Zipfian unigrams with a
  Markov flavour) for the token families: {"tokens": [B_local, S] int32,
  "labels": [B_local, S] int32}, labels the next token;
* ``SyntheticImageSource`` — CIFAR-shaped image/label batches for the cnn
  family: {"images": [B_local, IMG, IMG, C] float32, "labels": [B_local]
  int32}.

``MemmapSource`` reads packed uint16/uint32 token files (``np.memmap``,
written by :func:`write_token_file`), strided by (shard, step) for
disjoint coverage: the format a real run would use.

Batches are numpy arrays; the trainer moves them to its device.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class ShardInfo:
    index: int  # this host's shard index
    count: int  # number of data shards


class SyntheticSource:
    def __init__(self, vocab: int, seq_len: int, global_batch: int,
                 shard: ShardInfo = ShardInfo(0, 1), seed: int = 0):
        assert global_batch % shard.count == 0
        self.vocab, self.seq, self.batch = vocab, seq_len, global_batch // shard.count
        self.shard, self.seed = shard, seed
        # Zipf-ish unigram table (clipped to vocab).
        probs = 1.0 / np.arange(1, min(vocab, 50000) + 1) ** 1.1
        self._probs = probs / probs.sum()

    def __call__(self, step: int) -> dict:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.shard.index])
        )
        base = rng.choice(len(self._probs), size=(self.batch, self.seq + 1),
                          p=self._probs).astype(np.int64)
        # Markov flavour: each token mixes in the previous one.
        mixed = (base + np.roll(base, 1, axis=1) // 2) % self.vocab
        tokens = mixed[:, :-1].astype(np.int32)
        labels = mixed[:, 1:].astype(np.int32)
        return {"tokens": tokens, "labels": labels}


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


class MemmapSource:
    def __init__(self, path: str, vocab: int, seq_len: int, global_batch: int,
                 shard: ShardInfo = ShardInfo(0, 1), dtype=np.uint16):
        self.data = np.memmap(path, dtype=dtype, mode="r")
        assert global_batch % shard.count == 0
        self.vocab, self.seq = vocab, seq_len
        self.batch = global_batch // shard.count
        self.shard = shard
        self.n_windows = (len(self.data) - 1) // seq_len
        if self.n_windows < global_batch:
            raise ValueError("dataset too small for one global batch")

    def __call__(self, step: int) -> dict:
        g = self.batch * self.shard.count
        start = (step * g + self.shard.index * self.batch) % self.n_windows
        idx = (np.arange(self.batch) + start) % self.n_windows
        rows = np.stack([self.data[i * self.seq:i * self.seq + self.seq + 1] for i in idx])
        rows = rows.astype(np.int32) % self.vocab
        return {"tokens": rows[:, :-1], "labels": rows[:, 1:]}


def write_token_file(path: str, tokens: np.ndarray, dtype=np.uint16) -> None:
    np.asarray(tokens, dtype).tofile(path)
