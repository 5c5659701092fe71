"""Deterministic multi-stream batch index generator (counterpart of
dcase2019_task4_tpu/data/sampler.py, numpy only: the same draws).

Re-design of the reference `MultiStreamBatchSampler` (DataLoad.py:539-577):
each batch is a fixed layout of sub-batches drawn from every stream —
e.g. [weak ¼ | unlabeled ½ | synthetic ¼] — so that under jit the loss masks
are *static* slices of the batch tensor. Per-epoch permutation per stream;
epoch length = min over streams of len_i // bs_i (DataLoad.py:573-577).

Unlike the reference (implicit global numpy RNG), this generator is
explicitly seeded per epoch for reproducibility and multi-host determinism:
every host derives the same permutations from (seed, epoch) and slices its
own shard of each batch.
"""

from __future__ import annotations

from typing import Iterator, List, Sequence

import numpy as np


class MultiStreamSampler:
    """Yields batches of (stream_id, within-stream index) pairs.

    Args:
        stream_sizes: number of items in each stream.
        batch_sizes: per-stream sub-batch sizes; their sum is the batch size.
        seed: base RNG seed; epoch permutations derive from (seed, epoch).
    """

    def __init__(self, stream_sizes: Sequence[int], batch_sizes: Sequence[int], seed: int = 0):
        assert len(stream_sizes) == len(batch_sizes), (
            "batch_sizes must be the same length as the number of streams "
            f"{len(batch_sizes)} != {len(stream_sizes)}"
        )
        self.stream_sizes = list(stream_sizes)
        self.batch_sizes = list(batch_sizes)
        self.seed = seed

    def __len__(self) -> int:
        return min(n // b for n, b in zip(self.stream_sizes, self.batch_sizes) if b > 0)

    @property
    def batch_size(self) -> int:
        return sum(self.batch_sizes)

    def stream_slices(self) -> List[slice]:
        """Static batch-layout slices per stream (the jit-time loss masks).

        Mirrors main.py:238-247: weak_mask = slice(bs0),
        strong_mask = slice(bs0+bs1, batch_size)."""
        slices, start = [], 0
        for b in self.batch_sizes:
            slices.append(slice(start, start + b))
            start += b
        return slices

    def epoch_batches(self, epoch: int) -> np.ndarray:
        """All batches of one epoch as an int32 array
        [n_batches, batch_size, 2] of (stream_id, index) pairs."""
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, epoch]))
        n_batches = len(self)
        perms = [
            rng.permutation(n)[: n_batches * b].reshape(n_batches, b)
            for n, b in zip(self.stream_sizes, self.batch_sizes)
        ]
        out = np.empty((n_batches, self.batch_size, 2), dtype=np.int32)
        col = 0
        for s, (b, perm) in enumerate(zip(self.batch_sizes, perms)):
            out[:, col : col + b, 0] = s
            out[:, col : col + b, 1] = perm
            col += b
        return out

    def iter_epoch(self, epoch: int) -> Iterator[np.ndarray]:
        for batch in self.epoch_batches(epoch):
            yield batch


class ClusterRandomSampler:
    """Whole-batch-per-stream sampler: each batch is drawn entirely from ONE
    stream (batch-size per stream), batches shuffled globally — the
    reference's ClusterRandomSampler (DataLoad.py:488-536). Useful when
    streams must not mix inside a batch (e.g. per-domain BN statistics)."""

    def __init__(self, stream_sizes: Sequence[int], batch_sizes, seed: int = 0, shuffle: bool = True):
        if isinstance(batch_sizes, int):
            batch_sizes = [batch_sizes] * len(stream_sizes)
        assert len(batch_sizes) == len(stream_sizes)
        self.stream_sizes = list(stream_sizes)
        self.batch_sizes = list(batch_sizes)
        self.seed = seed
        self.shuffle = shuffle

    def __len__(self) -> int:
        return sum(n // b for n, b in zip(self.stream_sizes, self.batch_sizes))

    def epoch_batches(self, epoch: int) -> List[np.ndarray]:
        """List of [bs_i, 2] (stream_id, index) batches; short tails dropped
        like the reference."""
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, epoch, 7]))
        batches = []
        for s, (n, b) in enumerate(zip(self.stream_sizes, self.batch_sizes)):
            idx = rng.permutation(n) if self.shuffle else np.arange(n)
            for k in range(n // b):
                part = idx[k * b : (k + 1) * b]
                batch = np.stack([np.full(b, s, np.int32), part.astype(np.int32)], axis=1)
                batches.append(batch)
        if self.shuffle:
            order = rng.permutation(len(batches))
            batches = [batches[i] for i in order]
        return batches
