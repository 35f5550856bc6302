"""Synthetic data harness: the port's copy of
``vct.data.synthetic.generate_dummy_data`` (the reference's own smoke
pattern, ``lrcn/mamba.py:440-457``): random clips and labels, enough to
drive the whole train and eval stack without a dataset. The same seed gives
the same arrays as ``vct``.
"""

from __future__ import annotations

import numpy as np

__all__ = ["generate_dummy_data"]


def generate_dummy_data(
    num_samples: int = 32,
    sequence_length: int = 16,
    height: int = 64,
    width: int = 64,
    num_classes: int = 4,
    classif_mode: str = "multiclass",
    seed: int = 0,
):
    """(x (N, T, H, W, 3) f32 in [0, 1), y, class names): y int64 class ids
    for multiclass, (N, C) f32 0/1 for multiple_binary."""
    rng = np.random.RandomState(seed)
    x = rng.rand(num_samples, sequence_length, height, width, 3).astype(np.float32)
    if classif_mode == "multiclass":
        y = rng.randint(0, num_classes, size=(num_samples,)).astype(np.int64)
    else:
        y = (rng.rand(num_samples, num_classes) > 0.5).astype(np.float32)
    class_names = [f"class_{i}" for i in range(num_classes)]
    return x, y, class_names
