"""Batch inference: decoded videos -> frame selection -> batched softmax.

Port of the serving half of ``vct/serve/deployment.py``:

* ``sample_decoded_clips`` — the post-decode half of
  ``_load_with_device_sampling``: short videos are cycled up to T, longer
  ones are padded to a power-of-two length bucket and go through on-device
  frame selection (``device_sample_clips``) with their true length: SAD
  and flow scores from the ``pair_scores`` kernel, SSIM scores (``ssim``,
  ``ssim_most_unique``) from the ``ssim_pair_scores`` kernel.
* ``classify_videos`` — batched softmax probabilities, the final partial
  chunk zero-padded to ``batch_size`` so every forward has one shape.
* ``classify_and_display`` — the reference's output contract: per-video
  sorted labels and scores with a timestamp as JSON, ``Processed <name>:
  <label>`` lines and the label counts.

* ``load_model`` — rebuild a model from a vct_torch checkpoint on the card.

Video decoding, the CLI (``main``), ``post_results`` and mesh serving are
not ported yet (ROADMAP Queue 1), nor the converter of a ``vct`` (Orbax)
checkpoint (Queue 1 item 4), which ``load_model`` refuses.
"""

from __future__ import annotations

import json
import re
from collections import Counter
from datetime import datetime
from typing import List, Optional, Sequence

import numpy as np
import torch

from vct_torch.data.preprocess import device_sample_clips, preprocess_clips
from vct_torch.data.samplers import duplicate_frames
from vct_torch.device import resolve_device
from vct_torch.models import build_model
from vct_torch.train.checkpoint import load_checkpoint, load_weights

__all__ = [
    "construct_url",
    "load_model",
    "sample_decoded_clips",
    "classify_videos",
    "classify_and_display",
]


def construct_url(video_name: str) -> Optional[str]:
    """'@user_video_123.mp4' -> tiktok URL."""
    match = re.match(r"(?P<username>@.+?)_video_(?P<video_id>\d+)", video_name)
    if match:
        return (
            f"https://www.tiktok.com/{match.group('username')}"
            f"/video/{match.group('video_id')}"
        )
    return None


def load_model(model_dir: str, device=None):
    """Rebuild (model, class_names, cfg) from a vct_torch checkpoint
    directory, on ``device`` (default: the card), in eval mode. A ``vct``
    (Orbax) checkpoint raises ``ValueError``; a tensor that does not match
    the rebuilt model raises (``load_weights``)."""
    state_dict, cfg, class_names, _ = load_checkpoint(model_dir)
    model = build_model(cfg.model, cfg.data.sequence_length, device=device)
    load_weights(model, state_dict, model_dir)
    return model.eval(), class_names, cfg


_DEVICE_METHODS = {
    "uniform": "uniform",
    # uniform_seek only decodes differently; on decoded frames it is uniform.
    "uniform_seek": "uniform",
    "ssim": "ssim",
    "sad": "sad",
    "optical_flow": "flow",
    "optiflow": "flow",
    # The *_most_unique variants map to the plain transition-score selectors.
    "ssim_most_unique": "ssim",
    "optiflow_most_unique": "flow",
}


def _length_bucket(n_frames: int, seq_len: int) -> int:
    """Pad decoded length up to seq_len * 2^k: at most 2x selection work and
    a log-bounded number of distinct input shapes across arbitrary videos."""
    bucket = seq_len * 2
    while bucket < n_frames:
        bucket *= 2
    return bucket


def sample_decoded_clips(frames_per_video: Sequence[np.ndarray], sampling: str,
                         seq_len: int, device=None) -> torch.Tensor:
    """Decoded uint8 videos (a list of (n_i, H, W, 3) arrays) -> (N, T, H, W, 3)
    f32 clips on ``device`` (default: the card), one per video.

    Raises ``KeyError`` for an unknown sampling method and ``ValueError``
    for a video without frames.
    """
    if sampling not in _DEVICE_METHODS:
        raise KeyError(
            f"Unknown sampling method {sampling!r} for --device_sampling; "
            f"available: {sorted(_DEVICE_METHODS)}"
        )
    dev = resolve_device(device)
    method = _DEVICE_METHODS[sampling]
    clips = []
    for i, frames in enumerate(frames_per_video):
        frames = np.asarray(frames)
        n = len(frames)
        if n == 0:
            raise ValueError(f"video {i} has no frames")
        if n <= seq_len:
            padded = np.stack(duplicate_frames(list(frames), seq_len))[None]
            clip = preprocess_clips(torch.from_numpy(padded).to(dev))
        else:
            bucket = _length_bucket(n, seq_len)
            raw = np.empty((1, bucket) + frames.shape[1:], np.uint8)
            raw[0, :n] = frames
            raw[0, n:] = frames[-1]  # pad tail; masked out of selection
            clip = device_sample_clips(
                torch.from_numpy(raw).to(dev), seq_len, method=method,
                lengths=torch.tensor([n], device=dev),
            )
        clips.append(clip[0])
    if not clips:
        raise ValueError("no videos to sample")
    return torch.stack(clips)


@torch.inference_mode()
def classify_videos(model, clips, batch_size: int = 32, device=None) -> np.ndarray:
    """Softmax probabilities (N, num_classes) for (N, T, H, W, 3) clips.

    ``model`` must live on ``device`` (default: the card). The final
    partial chunk zero-pads up to ``batch_size``.
    """
    dev = resolve_device(device)
    x = torch.as_tensor(clips).to(dev, torch.float32)
    probs = []
    for start in range(0, len(x), batch_size):
        chunk = x[start:start + batch_size]
        n = len(chunk)
        if n < batch_size:
            pad = chunk.new_zeros((batch_size - n,) + tuple(chunk.shape[1:]))
            chunk = torch.cat([chunk, pad])
        p = torch.softmax(model(chunk).to(torch.float32), dim=-1)
        probs.append(p[:n].cpu().numpy())
    return np.concatenate(probs) if probs else np.zeros((0,), np.float32)


def classify_and_display(
    model, clips, video_names: List[str], class_names: List[str],
    batch_size: int = 32, probs: Optional[np.ndarray] = None, device=None,
) -> List[dict]:
    """The reference's output contract; ``probs`` skips the forward for
    callers that already have probabilities."""
    results = []
    label_counter = Counter()
    if probs is None:
        probs = classify_videos(model, clips, batch_size=batch_size, device=device)
    for idx, name in enumerate(video_names):
        order = np.argsort(-probs[idx])
        sorted_labels = [class_names[i] for i in order]
        sorted_scores = probs[idx][order].tolist()
        results.append(
            {
                "video_name": name,
                "labels": sorted_labels,
                "scores": sorted_scores,
                "timestamp": datetime.now().isoformat(),
            }
        )
        label_counter[sorted_labels[0]] += 1
        print(f"Processed {name}: {sorted_labels[0]}")

    print(json.dumps(results, indent=4))
    print("\nLabel Counts:")
    for label, count in label_counter.items():
        print(f"{label}: {count}")
    return results
