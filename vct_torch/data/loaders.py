"""Batch loaders: the port's copy of ``vct.data.loaders``.

``Trainer.fit`` / ``evaluate`` consume any object with

    num_examples: int
    batch_size:   int
    epoch(rng: np.random.RandomState | None) -> iter of (xb, yb, mask)

where ``xb`` is float32 (already normalized) or uint8 (normalized on the
device by the trainer). Exactly one ``rng.permutation(num_examples)`` is
consumed per shuffled epoch, so the same seed gives ``vct``'s epoch order on
every loader.

Loaders:
  * ArrayLoader        — in-memory arrays
  * HDF5Loader         — batches read from the HDF5 cache out of core
                         (``h5py`` imported when one is opened)
  * ClipCacheMapLoader — an mmap view of the native uint8 clip cache with
                         index subsets (the train/test split) and O(batch)
                         resident memory
  * ClipCacheStream    — the native multithreaded prefetch loader
                         (``vct_torch.data.clipcache.ClipCacheLoader``)
"""

from __future__ import annotations

import os
from typing import Iterator, Optional, Tuple

import numpy as np

__all__ = [
    "ArrayLoader",
    "HDF5Loader",
    "ClipCacheMapLoader",
    "ClipCacheStream",
    "as_loader",
    "cache_num_examples",
    "open_cache_loader",
    "split_indices",
]

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


class HDF5Loader:
    """Stream (videos, labels) batches from the HDF5 cache out of core.

    Labels are read once; video batches are gathered per step with h5py's
    fancy indexing, which needs sorted indices, so the gather reorders after
    the read and the epoch order stays ``ArrayLoader``'s.
    """

    def __init__(self, path: str, batch_size: int,
                 indices: Optional[np.ndarray] = None):
        import h5py

        self.path = path
        self.batch_size = batch_size
        self._hf = h5py.File(path, "r")
        self._videos = self._hf["videos"]
        self.clip_shape = tuple(int(s) for s in self._videos.shape[1:])
        n_total = self._videos.shape[0]
        self.indices = (
            np.asarray(indices, np.int64)
            if indices is not None
            else np.arange(n_total, dtype=np.int64)
        )
        self.num_examples = len(self.indices)
        self.labels = np.asarray(self._hf["labels"])[self.indices]

    def epoch(self, rng: Optional[np.random.RandomState] = None) -> Iterator[Batch]:
        order = _epoch_order(self.num_examples, rng)
        for start in range(0, self.num_examples, self.batch_size):
            sel = order[start : start + self.batch_size]
            file_idx = self.indices[sel]
            sort = np.argsort(file_idx)
            gathered = self._videos[file_idx[sort]]
            xb = np.empty_like(gathered)
            xb[sort] = gathered  # undo the sorted read's order
            yield _pad(xb, self.labels[sel], len(sel), self.batch_size)

    def close(self):
        if self._hf is not None:
            self._hf.close()
            self._hf = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


_CC_HEADER_DTYPE = np.dtype([
    ("magic", "<u8"), ("num_clips", "<u8"), ("t", "<u8"), ("h", "<u8"),
    ("w", "<u8"), ("c", "<u8"), ("label_kind", "<u8"), ("label_dim", "<u8"),
])
# kMagic of vct_torch/native/clipcache.cpp ("VCTC1"), vct's too.
_CC_MAGIC = 0x5643544331


def _read_cc_header(path: str):
    hd = np.fromfile(path, dtype=_CC_HEADER_DTYPE, count=1)
    if hd.size != 1 or hd[0]["magic"] != _CC_MAGIC:
        raise IOError(f"{path} is not a clip cache")
    return hd[0]


class ClipCacheMapLoader:
    """mmap view of the native clip cache with index subsets.

    The on-disk format of ``vct_torch/native/clipcache.cpp`` (header, label
    block, clip block); a file whose size disagrees with its header raises
    ``IOError``. Batches are gathered from the memory map, so resident
    memory stays O(batch). Yields uint8 clips.
    """

    def __init__(self, path: str, batch_size: int,
                 indices: Optional[np.ndarray] = None):
        self.batch_size = batch_size
        hd = _read_cc_header(path)
        n = int(hd["num_clips"])
        t, h, w, c = (int(hd[k]) for k in ("t", "h", "w", "c"))
        self.clip_shape = (t, h, w, c)
        label_kind, label_dim = int(hd["label_kind"]), int(hd["label_dim"])
        lb = 8 if label_kind == 0 else 4 * label_dim
        cb = t * h * w * c
        want = _CC_HEADER_DTYPE.itemsize + n * (lb + cb)
        if os.path.getsize(path) != want:
            raise IOError(f"{path}: size {os.path.getsize(path)} != expected {want}")
        off = _CC_HEADER_DTYPE.itemsize
        if label_kind == 0:
            self.labels = np.fromfile(path, "<i8", count=n, offset=off)
        else:
            self.labels = np.fromfile(
                path, "<f4", count=n * label_dim, offset=off
            ).reshape(n, label_dim)
        self._clips = np.memmap(
            path, np.uint8, "r", offset=off + n * lb, shape=(n, t, h, w, c)
        )
        self.indices = (
            np.asarray(indices, np.int64)
            if indices is not None
            else np.arange(n, dtype=np.int64)
        )
        self.num_examples = len(self.indices)
        self.labels = self.labels[self.indices]

    def epoch(self, rng: Optional[np.random.RandomState] = None) -> Iterator[Batch]:
        order = _epoch_order(self.num_examples, rng)
        for start in range(0, self.num_examples, self.batch_size):
            sel = order[start : start + self.batch_size]
            xb = np.asarray(self._clips[self.indices[sel]])  # gather: a copy in RAM
            yield _pad(xb, self.labels[sel], len(sel), self.batch_size)

    def close(self):
        self._clips = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class ClipCacheStream:
    """The loader API over the native prefetch loader
    (``vct_torch.data.clipcache.ClipCacheLoader``). The native side owns the
    shuffle (each epoch's permutation a function of (seed, epoch)); the
    trainer's rng is still consumed once an epoch so the other loaders stay
    in step, and ``set_epoch`` passes a resume on to the native stream."""

    def __init__(self, loader):
        self.loader = loader
        self.batch_size = loader.batch_size
        self.num_examples = int(loader.num_clips)

    def set_epoch(self, epoch: int) -> None:
        self.loader.set_epoch(epoch)

    def epoch(self, rng: Optional[np.random.RandomState] = None) -> Iterator[Batch]:
        if rng is not None:
            rng.permutation(self.num_examples)  # keep the stream position
        for xb, yb in self.loader.epoch():
            yield _pad(xb, yb, len(xb), self.batch_size)


def as_loader(x, y=None, batch_size: int = 32):
    """Coerce (x, y) arrays or a loader-shaped object to the loader API."""
    if hasattr(x, "epoch") and hasattr(x, "num_examples"):
        return x
    if hasattr(x, "epoch") and hasattr(x, "num_clips"):  # native ClipCacheLoader
        return ClipCacheStream(x)
    if y is None:
        raise TypeError(f"not a loader and no labels given: {type(x)!r}")
    return ArrayLoader(np.asarray(x), np.asarray(y), batch_size)


def open_cache_loader(cfg, indices: Optional[np.ndarray] = None,
                      batch_size: Optional[int] = None):
    """Open the configured dataset cache as a streaming loader
    (clipcache -> ClipCacheMapLoader, hdf5 -> HDF5Loader)."""
    d = cfg.data
    bs = batch_size or cfg.train.batch_size
    if d.cache_format == "clipcache":
        return ClipCacheMapLoader(d.data_file, bs, indices)
    return HDF5Loader(d.data_file, bs, indices)


def cache_num_examples(cfg) -> int:
    """Number of examples in the configured cache, read from its header."""
    d = cfg.data
    if d.cache_format == "clipcache":
        return int(_read_cc_header(d.data_file)["num_clips"])
    import h5py

    with h5py.File(d.data_file, "r") as hf:
        return hf["videos"].shape[0]
