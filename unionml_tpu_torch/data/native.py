"""Deterministic shuffled batches over row-aligned numpy arrays.

The port of :mod:`unionml_tpu.data.native`'s numpy path, with its
determinism contract: the epoch permutation is ``argsort(splitmix64(seed ^
(epoch + 1) * PHI ^ row))`` with ties broken by row index, so with the same
seed the port's trainer sees the reference trainer's batch order. (The
reference's C++ threaded host loader, ``_native/hostloader.cpp``, gives the
same stream and is queued, ROADMAP.md.)
"""

from __future__ import annotations

from typing import Iterator, Sequence, Tuple

import numpy as np

_PHI = np.uint64(0x9E3779B97F4A7C15)


def splitmix64(x: np.ndarray) -> np.ndarray:
    """Vectorized splitmix64 over uint64."""
    with np.errstate(over="ignore"):
        x = (x + _PHI).astype(np.uint64)
        x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return x ^ (x >> np.uint64(31))


def epoch_permutation(n_rows: int, seed: int, epoch: int, shuffle: bool = True) -> np.ndarray:
    """The loader's deterministic row order for ``epoch``."""
    if not shuffle:
        return np.arange(n_rows, dtype=np.uint64)
    with np.errstate(over="ignore"):
        base = np.uint64(seed) ^ (np.uint64(epoch + 1) * _PHI)
    keys = splitmix64(base ^ np.arange(n_rows, dtype=np.uint64))
    return np.argsort(keys, kind="stable").astype(np.uint64)


class BatchLoader:
    """Shuffled batches over arrays sharing their leading (row) dimension;
    each batch is a tuple of arrays in the given order. ``epoch(e,
    start_batch)`` resumes mid-epoch."""

    def __init__(
        self,
        arrays: Sequence[np.ndarray],
        *,
        batch_size: int,
        seed: int = 0,
        shuffle: bool = True,
        drop_remainder: bool = False,
    ):
        if not arrays:
            raise ValueError("BatchLoader needs at least one array")
        self.arrays = [np.ascontiguousarray(a) for a in arrays]
        n = self.arrays[0].shape[0]
        if any(a.shape[0] != n for a in self.arrays):
            raise ValueError("all arrays must share the leading dimension")
        self.n_rows = n
        self.batch_size = batch_size
        self.seed = seed
        self.shuffle = shuffle
        self.num_batches = n // batch_size if drop_remainder else -(-n // batch_size)

    def epoch(self, epoch: int = 0, start_batch: int = 0) -> Iterator[Tuple[np.ndarray, ...]]:
        """The batches of one epoch, from ``start_batch`` on."""
        perm = epoch_permutation(self.n_rows, self.seed, epoch, self.shuffle)
        for b in range(start_batch, self.num_batches):
            idx = perm[b * self.batch_size:(b + 1) * self.batch_size]
            yield tuple(a[idx] for a in self.arrays)

    def epochs(
        self, num_epochs: int, *, start_epoch: int = 0, start_batch: int = 0
    ) -> Iterator[Tuple[int, int, Tuple[np.ndarray, ...]]]:
        """``(epoch, batch_index, batch)`` across epochs, with resume."""
        for e in range(start_epoch, num_epochs):
            sb = start_batch if e == start_epoch else 0
            for i, batch in enumerate(self.epoch(e, sb)):
                yield e, sb + i, batch
