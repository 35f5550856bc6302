"""Frame-directory ingest (the UCF-Crime style PNG-frame datasets): the
port's copy of ``vct/data/frames.py``. cv2 reads the images.

The counterpart of ``lrcn/rgb_lrcn.py:114-164`` (class dirs of
``<video>_<n>_*.png`` frames grouped into clips by their name prefix, natural
numeric ordering, uniform or frame-difference sampling, zero-frame padding)
and ``lrcn/deployment.py:19-41`` ``preprocess_frames`` (one directory of
frames -> one padded/truncated clip).
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = ["natural_sort_key", "load_frames_dataset", "preprocess_frames_dir"]

IMG_EXTS = (".png", ".jpg", ".jpeg")


def natural_sort_key(name: str):
    """Sort 'frame_10.png' after 'frame_2.png' (rgb_lrcn natural_sort_key)."""
    return [int(tok) if tok.isdigit() else tok for tok in re.split(r"(\d+)", name)]


def _read_frame(path: str, height: int, width: int) -> np.ndarray:
    import cv2

    img = cv2.imread(path, cv2.IMREAD_COLOR)
    if img is None:
        raise IOError(f"Could not read image {path}")
    img = cv2.resize(img, (width, height))
    return (img.astype(np.float32) / 255.0)[..., ::-1]  # BGR -> RGB


def _sample_or_pad(frames: List[np.ndarray], sequence_length: int,
                   sampling_method: str, height: int, width: int):
    if len(frames) >= sequence_length:
        if sampling_method == "uniform":
            from vct_torch.data.samplers import uniform_sampling

            frames = uniform_sampling(frames, sequence_length)
        else:
            # frame-difference energy: keep the top-T most changed, in order
            # (rgb_lrcn.py:151-158 sample_frames/argsort pattern)
            diffs = np.array(
                [0.0]
                + [
                    float(np.abs(frames[i] - frames[i - 1]).sum())
                    for i in range(1, len(frames))
                ]
            )
            idx = np.sort(np.argsort(diffs)[-sequence_length:])
            frames = [frames[i] for i in idx]
    else:
        # zero-frame padding (rgb_lrcn.py:149-150,158-159)
        frames = frames + [np.zeros((height, width, 3), np.float32)] * (
            sequence_length - len(frames)
        )
    return np.stack(frames[:sequence_length])


def load_frames_dataset(
    dataset_path: str,
    class_labels: Optional[List[str]] = None,
    sequence_length: int = 40,
    max_videos_per_class: int = 700,
    sampling_method: str = "uniform",
    img_height: int = 80,
    img_width: int = 80,
) -> Tuple[np.ndarray, np.ndarray, List[str]]:
    """Class dirs of per-video frame PNGs -> (N, T, H, W, 3), labels, classes.

    Frames group into videos by the first two '_'-separated tokens of the
    filename (rgb_lrcn.py:128).
    """
    if class_labels is None:
        class_labels = sorted(
            d for d in os.listdir(dataset_path)
            if os.path.isdir(os.path.join(dataset_path, d))
        )
    sequences, labels = [], []
    for class_idx, class_label in enumerate(class_labels):
        class_path = os.path.join(dataset_path, class_label)
        video_dict: Dict[str, List[np.ndarray]] = {}
        for img_name in sorted(os.listdir(class_path), key=natural_sort_key):
            if not img_name.lower().endswith(IMG_EXTS):
                continue
            video_name = "_".join(img_name.split("_")[:2])
            video_dict.setdefault(video_name, [])
            if len(video_dict) > max_videos_per_class:
                video_dict.pop(video_name)
                break
            try:
                video_dict[video_name].append(
                    _read_frame(os.path.join(class_path, img_name),
                                img_height, img_width)
                )
            except Exception as e:
                print(f"Error processing {img_name}: {e}")

        count = 0
        for video_name, frames in video_dict.items():
            if count >= max_videos_per_class or not frames:
                continue
            sequences.append(
                _sample_or_pad(frames, sequence_length, sampling_method,
                               img_height, img_width)
            )
            labels.append(class_idx)
            count += 1
    x = (
        np.stack(sequences).astype(np.float32)
        if sequences
        else np.zeros((0, sequence_length, img_height, img_width, 3), np.float32)
    )
    return x, np.asarray(labels, np.int64), class_labels


def preprocess_frames_dir(
    frames_path: str,
    sequence_length: int = 40,
    img_height: int = 80,
    img_width: int = 80,
) -> np.ndarray:
    """One directory of frames -> (1, T, H, W, 3) clip, zero-padded or
    truncated (lrcn/deployment.py:19-41)."""
    frame_files = sorted(
        (f for f in os.listdir(frames_path) if f.lower().endswith(IMG_EXTS)),
        key=natural_sort_key,
    )
    frames = [
        _read_frame(os.path.join(frames_path, f), img_height, img_width)
        for f in frame_files
    ]
    if len(frames) < sequence_length:
        frames += [np.zeros((img_height, img_width, 3), np.float32)] * (
            sequence_length - len(frames)
        )
    return np.stack(frames[:sequence_length])[None]
