"""Batch loaders, the in-memory part: the port's copy of
``vct.data.loaders``' ``split_indices``, ``ArrayLoader`` and ``as_loader``.

``Trainer.fit`` / ``evaluate`` consume any object with

    num_examples: int
    batch_size:   int
    epoch(rng: np.random.RandomState | None) -> iter of (xb, yb, mask)

Exactly one ``rng.permutation(num_examples)`` is consumed per shuffled
epoch, so the same seed gives ``vct``'s epoch order. The HDF5 and clip-cache
loaders are not ported yet (ROADMAP Queue 1 item 3).
"""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

import numpy as np

__all__ = ["ArrayLoader", "as_loader", "split_indices"]

Batch = Tuple[np.ndarray, np.ndarray, np.ndarray]


def split_indices(n: int, test_fraction: float = 0.2, seed: int = 42):
    """Index-level train/test split (the permutation split of
    ``vct_torch.data.batcher.train_test_split``, without touching the data)."""
    order = np.random.RandomState(seed).permutation(n)
    n_test = int(round(n * test_fraction))
    return np.sort(order[n_test:]), np.sort(order[:n_test])


def _pad(xb, yb, k, batch_size) -> Batch:
    mask = np.ones(k, np.float32)
    if k < batch_size:
        pad = batch_size - k
        xb = np.concatenate([xb, np.zeros((pad,) + xb.shape[1:], xb.dtype)])
        yb = np.concatenate([yb, np.zeros((pad,) + yb.shape[1:], yb.dtype)])
        mask = np.concatenate([mask, np.zeros(pad, np.float32)])
    return xb, yb, mask


def _epoch_order(n: int, rng: Optional[np.random.RandomState]) -> np.ndarray:
    return rng.permutation(n) if rng is not None else np.arange(n)


class ArrayLoader:
    """Wrap in-memory (x, y) arrays."""

    def __init__(self, x: np.ndarray, y: np.ndarray, batch_size: int):
        self.x, self.y = x, y
        self.batch_size = batch_size
        self.num_examples = len(x)

    def epoch(self, rng: Optional[np.random.RandomState] = None) -> Iterator[Batch]:
        order = _epoch_order(self.num_examples, rng)
        for start in range(0, self.num_examples, self.batch_size):
            idx = order[start : start + self.batch_size]
            yield _pad(self.x[idx], self.y[idx], len(idx), self.batch_size)


def as_loader(x, y=None, batch_size: int = 32):
    """Coerce (x, y) arrays or a loader-shaped object to the loader API."""
    if hasattr(x, "epoch") and hasattr(x, "num_examples"):
        return x
    if y is None:
        raise TypeError(f"not a loader and no labels given: {type(x)!r}")
    return ArrayLoader(np.asarray(x), np.asarray(y), batch_size)
