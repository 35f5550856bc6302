"""Synthetic data harness: the port's copy of ``vct/data/synthetic.py``.

``generate_dummy_data`` is the reference's own smoke pattern
(``lrcn/mamba.py:440-457``): random clips and labels, enough to drive the
whole train and eval stack without a dataset. The same seed gives the same
arrays as ``vct``.

``generate_motion_dataset`` writes a learnable video benchmark: real mp4
files whose classes differ only in temporal dynamics, so a model must read
motion (not a single frame) to classify. The files flow through the real
ingest path (decode, sampling, clip cache), as the serving rehearsal
(``vct_torch.tools.serve_rehearsal``) drives them. The same seed writes the
same frames as ``vct``.
"""

from __future__ import annotations

import os

import numpy as np

__all__ = ["generate_dummy_data", "generate_motion_dataset", "MOTION_CLASSES"]


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


# Classes separable ONLY by temporal dynamics: each clip renders a circle
# whose color sweeps red->blue (and radius small->big) along a per-class
# schedule u(t). "forward" and "reverse" produce IDENTICAL per-frame
# marginal distributions (the same frame set, time-reversed), so no single
# frame can separate them — the temporal stack has to read the ordering.
# "flicker" alternates between the two endpoints; "steady" holds the
# midpoint. The color sweep rotates the backbone feature DIRECTION (not just
# its magnitude), so the signal survives the adapter's LayerNorms.
MOTION_CLASSES = ("flicker", "forward", "reverse", "steady")


def _motion_schedule(name: str, t: int, frames: int) -> float:
    frac = t / max(frames - 1, 1)
    if name == "forward":
        return frac
    if name == "reverse":
        return 1.0 - frac
    if name == "flicker":
        return float(t % 2)
    return 0.5  # steady


def generate_motion_dataset(
    root: str,
    clips_per_class=(16, 16, 16, 16),
    frames: int = 16,
    size: int = 64,
    fps: int = 10,
    seed: int = 0,
) -> list:
    """Write a dataset tree of real mp4 files, one directory per motion
    class (the ``scan_classes`` layout ``ingest.py`` consumes). Per-clip
    randomness — center, radius range, background noise — keeps single-frame
    memorization off the table while the temporal signal stays strong
    through lossy mp4 encoding and frame sub-sampling.

    ``clips_per_class`` may be imbalanced to exercise the balanced-weight CE
    path (``compute_class_weights``). Returns the class names (sorted, as
    ``scan_classes`` will report them). Raises ``IOError`` where cv2 cannot
    open an mp4v writer."""
    import cv2

    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:size, 0:size]
    for name, n_clips in zip(MOTION_CLASSES, clips_per_class):
        class_dir = os.path.join(root, name)
        os.makedirs(class_dir, exist_ok=True)
        for clip_i in range(n_clips):
            cx = rng.randint(size // 3, 2 * size // 3)
            cy = rng.randint(size // 3, 2 * size // 3)
            r_small = size // 10 + rng.randint(0, 3)
            r_big = size // 4 + rng.randint(0, 4)
            path = os.path.join(class_dir, f"clip_{clip_i:03d}.mp4")
            writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (size, size))
            if not writer.isOpened():
                raise IOError(f"cv2.VideoWriter could not open {path}")
            for t in range(frames):
                u = _motion_schedule(name, t, frames)
                radius = r_small + u * (r_big - r_small)
                color = np.array([255 * (1 - u), 40, 255 * u], np.uint8)
                frame = rng.randint(0, 40, (size, size, 3)).astype(np.uint8)
                frame[(xx - cx) ** 2 + (yy - cy) ** 2 <= radius**2] = color
                # VideoWriter expects BGR; flip so the decoded RGB matches.
                writer.write(frame[:, :, ::-1])
            writer.release()
    return sorted(MOTION_CLASSES)
