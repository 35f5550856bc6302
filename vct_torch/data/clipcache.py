"""Python bindings for the native clip cache (``vct_torch/native/clipcache.cpp``).

The port's copy of ``vct/data/clipcache.py``: a memory-mapped uint8 clip
store and a multithreaded prefetching batch loader. Clips stay uint8 on disk
and over the host-to-device copy; the trainer normalizes them on the device.
The on-disk format is ``vct``'s (magic ``VCTC1``, header, label block, uint8
clips), so a cache written by either package reads in the other.

The shared library builds on first use with ``g++`` under an exclusive file
lock into ``.vct_torch_build/host-<hash>/`` at the checkout's root, keyed by
the source and the command, so a changed source rebuilds and nothing is
written beside the source. ctypes keeps the GIL out of the gather threads.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Iterator, Sequence, Tuple

import numpy as np

__all__ = ["ClipCacheWriter", "ClipCacheLoader", "build_host_library", "write_clipcache"]

_NATIVE = Path(__file__).resolve().parent.parent / "native"
_BUILD_ROOT = Path(__file__).resolve().parent.parent.parent / ".vct_torch_build"
_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")
_lib = None


def build_host_library(source: str, flags: Sequence[str], libs: Sequence[str] = ()) -> Path:
    """Compile ``vct_torch/native/<source>`` with ``g++`` if it is not built
    yet; returns the library's path, ``.vct_torch_build/host-<hash>/lib<stem>.so``.

    The hash covers the source and the command. The build runs under an
    exclusive lock on the directory and renames the finished library into
    place, so concurrent processes never load a half-written one. Raises
    ``RuntimeError`` with the compiler's output when the build fails.
    """
    src = _NATIVE / source
    cmd = ["g++", *flags, str(src), *libs]
    h = hashlib.sha256(" ".join(cmd[1:]).encode())
    h.update(src.read_bytes())
    out_dir = _BUILD_ROOT / f"host-{h.hexdigest()[:16]}"
    lib = out_dir / f"lib{src.stem}.so"
    if lib.is_file():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if lib.is_file():  # another process built it while we waited
                return lib
            tmp = out_dir / f"{lib.name}.tmp.{os.getpid()}"
            proc = subprocess.run(cmd + ["-o", str(tmp)], capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"g++ failed on {src.name}:\n{proc.stdout}{proc.stderr}")
            os.replace(tmp, lib)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return lib


def _load():
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build_host_library("clipcache.cpp", _FLAGS)))
    i64, u64, p = ctypes.c_int64, ctypes.c_uint64, ctypes.c_void_p
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.ccw_open.restype = p
    lib.ccw_open.argtypes = [ctypes.c_char_p, i64, i64, i64, i64, i64, i64]
    lib.ccw_append.restype = ctypes.c_int
    lib.ccw_append.argtypes = [p, u8p, ctypes.POINTER(i64), ctypes.POINTER(ctypes.c_float)]
    lib.ccw_close.restype = ctypes.c_int
    lib.ccw_close.argtypes = [p]
    lib.ccl_open.restype = p
    lib.ccl_open.argtypes = [ctypes.c_char_p, i64, ctypes.c_int, u64,
                             ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.ccl_num_clips.restype = i64
    lib.ccl_num_clips.argtypes = [p]
    lib.ccl_num_batches.restype = i64
    lib.ccl_num_batches.argtypes = [p]
    lib.ccl_dims.restype = None
    lib.ccl_dims.argtypes = [p, ctypes.POINTER(i64)]
    lib.ccl_next.restype = i64
    lib.ccl_next.argtypes = [p, u8p, u8p, i64]
    lib.ccl_next_epoch.restype = None
    lib.ccl_next_epoch.argtypes = [p]
    lib.ccl_set_epoch.restype = None
    lib.ccl_set_epoch.argtypes = [p, i64]
    lib.ccl_close.restype = None
    lib.ccl_close.argtypes = [p]
    _lib = lib
    return lib


class ClipCacheWriter:
    """Stream (T, H, W, C) uint8 clips + labels into a cache file."""

    def __init__(self, path: str, t: int, h: int, w: int, c: int = 3,
                 label_dim: int = 0):
        """label_dim=0 -> int64 class labels; >0 -> float32 label vectors."""
        self._lib = _load()
        self.shape = (t, h, w, c)
        self.label_dim = label_dim
        self._handle = self._lib.ccw_open(
            str(path).encode(), t, h, w, c, 0 if label_dim == 0 else 1, label_dim
        )
        if not self._handle:
            raise IOError(f"could not open {path} for writing")

    def append(self, clip: np.ndarray, label) -> None:
        clip = np.ascontiguousarray(clip, np.uint8)
        if clip.shape != self.shape:
            raise ValueError(f"clip shape {clip.shape} != {self.shape}")
        clip_p = clip.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
        if self.label_dim == 0:
            lab = ctypes.c_int64(int(label))
            rc = self._lib.ccw_append(self._handle, clip_p, ctypes.byref(lab), None)
        else:
            flab = np.ascontiguousarray(label, np.float32)
            if flab.shape != (self.label_dim,):
                raise ValueError(f"label shape {flab.shape} != ({self.label_dim},)")
            rc = self._lib.ccw_append(
                self._handle, clip_p, None,
                flab.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            )
        if rc != 0:
            raise IOError("append failed")

    def close(self) -> None:
        if self._handle:
            # Clear the handle first: ccw_close always frees the native
            # writer, so a raise here must not let a later close() free it again.
            handle, self._handle = self._handle, None
            if self._lib.ccw_close(handle) != 0:
                raise IOError("finalize failed")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class ClipCacheLoader:
    """Iterate shuffled uint8 batches assembled by native worker threads."""

    def __init__(self, path: str, batch_size: int, shuffle: bool = True,
                 seed: int = 0, workers: int = 4, drop_last: bool = False,
                 prefetch_depth: int = 3):
        self._lib = _load()
        self._handle = self._lib.ccl_open(
            str(path).encode(), batch_size, int(shuffle), seed, workers,
            int(drop_last), prefetch_depth,
        )
        if not self._handle:
            raise IOError(f"could not open clip cache {path}")
        self.batch_size = batch_size
        dims = (ctypes.c_int64 * 6)()
        self._lib.ccl_dims(self._handle, dims)
        self.t, self.h, self.w, self.c = dims[0], dims[1], dims[2], dims[3]
        self.label_kind, self.label_dim = dims[4], dims[5]
        self.num_clips = self._lib.ccl_num_clips(self._handle)

    @property
    def num_batches(self) -> int:
        return self._lib.ccl_num_batches(self._handle)

    def set_epoch(self, epoch: int) -> None:
        """Jump the native shuffle stream to ``epoch``: each epoch's
        permutation is a function of (seed, epoch) alone, so a resumed run
        sees what an uninterrupted one would."""
        self._lib.ccl_set_epoch(self._handle, epoch)

    def epoch(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Yield (clips uint8 (n,T,H,W,C), labels) for one epoch, then
        prepare the next (reshuffled)."""
        clips = np.empty((self.batch_size, self.t, self.h, self.w, self.c), np.uint8)
        if self.label_kind == 0:
            labels = np.empty((self.batch_size,), np.int64)
        else:
            labels = np.empty((self.batch_size, self.label_dim), np.float32)
        clips_p = clips.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
        labels_p = labels.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
        consumed = 0
        try:
            while True:
                n = self._lib.ccl_next(self._handle, clips_p, labels_p, consumed)
                if n <= 0:
                    break
                consumed += 1
                yield clips[:n].copy(), labels[:n].copy()
        finally:
            # Leaving the generator mid-epoch must not wedge the next epoch.
            if self._handle:
                self._lib.ccl_next_epoch(self._handle)

    def close(self) -> None:
        if self._handle:
            self._lib.ccl_close(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def write_clipcache(path: str, clips_u8: np.ndarray, labels: np.ndarray) -> str:
    """Write an (N, T, H, W, C) uint8 array + labels (int (N,) or float
    (N, K)) as a clip cache; returns ``path``."""
    n, t, h, w, c = clips_u8.shape
    label_dim = 0 if labels.ndim == 1 else labels.shape[1]
    with ClipCacheWriter(path, t, h, w, c, label_dim) as writer:
        for i in range(n):
            writer.append(clips_u8[i], labels[i])
    return path
