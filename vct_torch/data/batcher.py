"""Static-shape batch iteration and the train/test split: the port's copy of
``vct.data.batcher``.

The final partial batch is zero-padded and carries a validity mask that the
loss and metrics respect; shuffling matches the epoch reshuffle of
``DataLoader(shuffle=True)``.
"""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

import numpy as np

__all__ = ["batches", "train_test_split"]


def batches(
    x: np.ndarray,
    y: np.ndarray,
    batch_size: int,
    shuffle: bool = False,
    rng: Optional[np.random.RandomState] = None,
    pad_final: bool = True,
) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Yield (x_b, y_b, mask) with static batch_size shapes."""
    n = len(x)
    order = np.arange(n)
    if shuffle:
        (rng or np.random.RandomState(0)).shuffle(order)
    for start in range(0, n, batch_size):
        idx = order[start : start + batch_size]
        xb, yb = x[idx], y[idx]
        mask = np.ones(len(idx), np.float32)
        if len(idx) < batch_size:
            if not pad_final:
                continue
            pad = batch_size - len(idx)
            xb = np.concatenate([xb, np.zeros((pad,) + xb.shape[1:], xb.dtype)])
            yb = np.concatenate([yb, np.zeros((pad,) + yb.shape[1:], yb.dtype)])
            mask = np.concatenate([mask, np.zeros(pad, np.float32)])
        yield xb, yb, mask


def train_test_split(x, y, test_fraction: float = 0.2, seed: int = 42):
    """Deterministic permutation split (sklearn ``train_test_split`` at
    ``random_state=42``). Rows come back in permutation order;
    ``vct_torch.data.loaders.split_indices`` draws the same membership,
    sorted."""
    n = len(x)
    order = np.random.RandomState(seed).permutation(n)
    n_test = int(round(n * test_fraction))
    test_idx, train_idx = order[:n_test], order[n_test:]
    return x[train_idx], x[test_idx], y[train_idx], y[test_idx]
