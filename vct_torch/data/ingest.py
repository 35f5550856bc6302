"""Dataset ingest: class-directory scan -> decode -> sample -> cache. The
port's copy of ``vct/data/ingest.py``; the caches it writes are ``vct``'s,
byte for byte (the clip cache and the HDF5 file; ``h5py`` is imported only
when an HDF5 cache is built or read, so a host without it uses the clip
cache).

The counterpart of ``loader_data.py:210-328`` (``load_dataset``: resizable
HDF5 ``videos``+``labels`` datasets appended batch-wise, per-class caps,
multiclass int labels or one-hot float labels) and ``loader_data.py:127-207``
(``load_dataset_simple``: in-memory arrays), with the decode fanned out over
a process pool. Cache filenames keep the reference's config-keyed convention
(``all_config.py:32-35``). ``load_dataset_inference`` mirrors
``loader_data.py:459-523`` minus its delete-while-iterating race (SURVEY.md §5
flags it); classified-URL filtering is the serving layer's job.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np

from vct_torch.core.config import Config
from vct_torch.data.video import ParallelDecoder

__all__ = [
    "scan_classes",
    "build_dataset_cache",
    "build_clipcache",
    "load_dataset_cache",
    "ensure_cache",
    "load_or_build_dataset",
    "load_dataset_simple",
    "load_dataset_inference",
]

VIDEO_EXTS = (".mp4", ".avi", ".mov", ".mkv", ".webm")


def scan_classes(path: str) -> List[str]:
    return sorted(
        d for d in os.listdir(path) if os.path.isdir(os.path.join(path, d))
    )


def _class_videos(class_dir: str, cap: int) -> List[str]:
    files = sorted(
        f for f in os.listdir(class_dir) if f.lower().endswith(VIDEO_EXTS)
    )
    return [os.path.join(class_dir, f) for f in files[:cap]]


def build_dataset_cache(cfg: Config, path: Optional[str] = None) -> Tuple[str, str]:
    """Decode the dataset tree into the HDF5 cache; returns
    (data_file, classes_file) paths."""
    import h5py

    d = cfg.data
    path = path or d.dataset_path
    classes = scan_classes(path)
    print("Found classes:", classes)
    num_classes = len(classes)
    multiclass = cfg.model.classif_mode == "multiclass"
    os.makedirs(d.processed_data_path, exist_ok=True)

    decoder = ParallelDecoder(d.decode_workers, d.decoder)
    total = 0
    with h5py.File(d.data_file, "w") as hf:
        hf.create_dataset(
            "videos",
            shape=(0, d.sequence_length, d.img_height, d.img_width, 3),
            maxshape=(None, d.sequence_length, d.img_height, d.img_width, 3),
            dtype=np.float32,
            chunks=(1, d.sequence_length, d.img_height, d.img_width, 3),
        )
        if multiclass:
            hf.create_dataset("labels", shape=(0,), maxshape=(None,), dtype=np.int64)
        else:
            hf.create_dataset(
                "labels", shape=(0, num_classes), maxshape=(None, num_classes),
                dtype=np.float32,
            )

        for class_idx, class_name in enumerate(classes):
            videos = _class_videos(os.path.join(path, class_name), d.max_videos)
            print(f"Processing class: {class_name} ({len(videos)} videos)")
            batch_clips: List[np.ndarray] = []

            def flush():
                nonlocal total
                if not batch_clips:
                    return
                n = len(batch_clips)
                cur = hf["videos"].shape[0]
                hf["videos"].resize(cur + n, axis=0)
                hf["labels"].resize(cur + n, axis=0)
                hf["videos"][cur : cur + n] = np.stack(batch_clips)
                if multiclass:
                    hf["labels"][cur : cur + n] = np.full(n, class_idx, np.int64)
                else:
                    onehot = np.zeros((n, num_classes), np.float32)
                    onehot[:, class_idx] = 1.0
                    hf["labels"][cur : cur + n] = onehot
                total += n
                batch_clips.clear()
                print(f"Saved batch: {n} videos, Total: {total}")

            for _, clip in decoder.decode_many(
                videos, d.img_height, d.img_width, d.sequence_length,
                d.sampling_method,
            ):
                batch_clips.append(clip)
                if len(batch_clips) >= cfg.train.batch_size:
                    flush()
            flush()

    np.save(d.classes_file, np.asarray(classes))
    print(f"Dataset processing complete. Total videos: {total}")
    return d.data_file, d.classes_file


def build_clipcache(cfg: Config, path: Optional[str] = None) -> str:
    """Decode the dataset tree into the native uint8 clip cache
    (``vct_torch.data.clipcache``) — normalization happens on-device."""
    from vct_torch.data.clipcache import ClipCacheWriter

    d = cfg.data
    path = path or d.dataset_path
    classes = scan_classes(path)
    print("Found classes:", classes)
    num_classes = len(classes)
    multiclass = cfg.model.classif_mode == "multiclass"
    os.makedirs(d.processed_data_path, exist_ok=True)
    decoder = ParallelDecoder(d.decode_workers, d.decoder)

    total = 0
    with ClipCacheWriter(
        d.data_file, d.sequence_length, d.img_height, d.img_width, 3,
        label_dim=0 if multiclass else num_classes,
    ) as writer:
        for class_idx, class_name in enumerate(classes):
            videos = _class_videos(os.path.join(path, class_name), d.max_videos)
            print(f"Processing class: {class_name} ({len(videos)} videos)")
            for _, clip in decoder.decode_many(
                videos, d.img_height, d.img_width, d.sequence_length,
                d.sampling_method, normalize=False,
            ):
                if multiclass:
                    writer.append(clip, class_idx)
                else:
                    onehot = np.zeros(num_classes, np.float32)
                    onehot[class_idx] = 1.0
                    writer.append(clip, onehot)
                total += 1
    np.save(d.classes_file, np.asarray(classes))
    print(f"Dataset processing complete. Total videos: {total}")
    return d.data_file


def load_dataset_cache(cfg: Config) -> Tuple[np.ndarray, np.ndarray, List[str]]:
    d = cfg.data
    classes = [str(c) for c in np.load(d.classes_file, allow_pickle=True)]
    if d.cache_format == "clipcache":
        from vct_torch.data.clipcache import ClipCacheLoader

        with ClipCacheLoader(
            d.data_file, batch_size=64, shuffle=False, workers=d.decode_workers
        ) as loader:
            xs, ys = [], []
            for xb, yb in loader.epoch():
                xs.append(xb)
                ys.append(yb)
        x = np.concatenate(xs).astype(np.float32) / 255.0
        y = np.concatenate(ys)
        return x, y, classes
    import h5py

    with h5py.File(d.data_file, "r") as hf:
        x = np.asarray(hf["videos"])
        y = np.asarray(hf["labels"])
    return x, y, classes


def _check_cache_compatible(cfg: Config) -> None:
    """Reject an existing cache whose geometry/labels don't match the config.

    The cache filename convention (all_config.py:32-35 parity) keys only
    (max_videos, seq_len, sampling) — img size and classif_mode changes would
    otherwise silently reuse stale clips of the wrong resolution or labels of
    the wrong kind (the fully-convolutional backbones accept any size, so
    nothing downstream would catch it)."""
    d = cfg.data
    want = (d.sequence_length, d.img_height, d.img_width)
    multilabel = cfg.model.classif_mode == "multiple_binary"
    got_classes = None  # one-hot label width, when the format exposes it
    if d.cache_format == "clipcache":
        from vct_torch.data.loaders import _read_cc_header

        hd = _read_cc_header(d.data_file)
        got = (int(hd["t"]), int(hd["h"]), int(hd["w"]))
        got_multi = int(hd["label_kind"]) != 0
        if got_multi:
            got_classes = int(hd["label_dim"])
    else:
        import h5py

        with h5py.File(d.data_file, "r") as hf:
            got = tuple(int(s) for s in hf["videos"].shape[1:4])
            got_multi = hf["labels"].ndim > 1
            if got_multi:
                got_classes = int(hf["labels"].shape[1])
    if os.path.exists(d.classes_file):
        # A class-count mismatch (cache built from a different class set)
        # would otherwise train against silently misaligned labels.
        n_listed = len(np.load(d.classes_file, allow_pickle=True))
        if got_classes is None:
            got_classes = n_listed
        elif n_listed != got_classes:
            raise ValueError(
                f"cache {d.data_file} has {got_classes}-wide labels but "
                f"{d.classes_file} lists {n_listed} classes — stale pair."
            )
    if got != want or got_multi != multilabel or (
        got_classes is not None and got_classes != cfg.model.num_classes
    ):
        raise ValueError(
            f"cache {d.data_file} was built with (T,H,W)={got}, "
            f"multilabel={got_multi}, classes={got_classes}, but the config "
            f"wants (T,H,W)={want}, multilabel={multilabel}, "
            f"classes={cfg.model.num_classes}. Delete the stale cache or "
            "point data.data_file elsewhere."
        )


def ensure_cache(cfg: Config) -> None:
    """Build the configured dataset cache if it does not exist yet; refuse
    an existing cache that is incompatible with the config."""
    d = cfg.data
    if os.path.exists(d.data_file) and os.path.exists(d.classes_file):
        _check_cache_compatible(cfg)
        return
    if not d.dataset_path:
        raise ValueError(
            "No dataset cache found and data.dataset_path is empty "
            "(set data.synthetic=true for the synthetic harness)"
        )
    if d.cache_format == "clipcache":
        build_clipcache(cfg)
    else:
        build_dataset_cache(cfg)


def load_or_build_dataset(cfg: Config):
    ensure_cache(cfg)
    return load_dataset_cache(cfg)


def load_dataset_simple(
    path: str,
    img_height: int,
    img_width: int,
    sequence_length: int,
    max_videos_per_class: int = 100,
    task_type: str = "multiclass",
    sampling_method: str = "uniform",
    decode_workers: int = 4,
):
    """In-memory variant (loader_data.py:127-207)."""
    classes = scan_classes(path)
    num_classes = len(classes)
    decoder = ParallelDecoder(decode_workers)
    data, labels = [], []
    for class_idx, class_name in enumerate(classes):
        videos = _class_videos(os.path.join(path, class_name), max_videos_per_class)
        print(f"Loading class: {class_name}")
        for _, clip in decoder.decode_many(
            videos, img_height, img_width, sequence_length, sampling_method
        ):
            data.append(clip)
            if task_type == "multiclass":
                labels.append(class_idx)
            else:
                onehot = np.zeros(num_classes, np.float32)
                onehot[class_idx] = 1.0
                labels.append(onehot)
    x = np.asarray(data, np.float32)
    y = np.asarray(labels, np.int64 if task_type == "multiclass" else np.float32)
    print(f"Final data shape: {x.shape}")
    print(f"Final labels shape: {y.shape}")
    return x, y, classes


def load_dataset_inference(
    path: str,
    sampling_method: str = "uniform",
    sequence_length: int = 30,
    img_height: int = 80,
    img_width: int = 80,
    skip: Optional[List[str]] = None,
    decode_workers: int = 4,
) -> Tuple[np.ndarray, List[str]]:
    """Directory of videos -> (N, T, H, W, 3) float32 batch + names."""
    skip_set = set(skip or ())
    files = sorted(
        f for f in os.listdir(path)
        if f.lower().endswith(VIDEO_EXTS) and f not in skip_set
    )
    decoder = ParallelDecoder(decode_workers)
    data, names = [], []
    for p, clip in decoder.decode_many(
        [os.path.join(path, f) for f in files],
        img_height, img_width, sequence_length, sampling_method,
    ):
        data.append(clip)
        names.append(os.path.basename(p))
    x = (
        np.asarray(data, np.float32)
        if data
        else np.zeros((0, sequence_length, img_height, img_width, 3), np.float32)
    )
    print(f"Final data shape: {x.shape}")
    return x, names
