"""Host-side video decode: the port's copy of ``vct/data/video.py``.

OpenCV's read -> resize -> BGR->RGB loop (the reference's), or the native
ffmpeg decoder (``vct_torch.data.videodec``), fanned out over a process pool
with a bounded prefetch window (``ParallelDecoder``). Everything here returns
numpy; nothing touches torch or the card, so the pool's workers never hold a
CUDA context. The workers are started by ``spawn``: a fork of a process that
holds a CUDA context and torch's threads is not safe. A spawned worker
imports the caller's main module first, so a program read from standard
input cannot use more than one worker; run it from a file or with ``-m``.

cv2.resize takes (width, height); the reference passed (height, width),
harmless for its square frames. Here it is (width, height), as in ``vct``.
"""

from __future__ import annotations

import multiprocessing
import os
from collections import deque
from concurrent.futures import ProcessPoolExecutor
from typing import Iterable, List, Optional, Tuple

import numpy as np

__all__ = ["decode_video", "decode_uniform_seek", "decode_and_sample", "ParallelDecoder"]


def decode_video(
    path: str,
    height: int,
    width: int,
    max_frames: Optional[int] = None,
    to_rgb: bool = True,
    decoder: str = "cv2",
) -> List[np.ndarray]:
    """Decode a video into a list of resized HxWx3 uint8 RGB frames.

    decoder:
      * "cv2" (default): the reference's decode path.
      * "native": the C++ ffmpeg decoder (``vct_torch.data.videodec``):
        cv2's pixels where cv2 imports (source-size decode + cv2 resize),
        swscale's bilinear resize where it does not. Raises where the
        decoder does not build (``videodec.is_available()`` is False).
      * "auto": cv2 when importable, else the native decoder."""
    if to_rgb and decoder != "cv2":
        try:
            import cv2  # noqa: F401

            has_cv2 = True
        except ImportError:
            has_cv2 = False
        if decoder == "native" or not has_cv2:
            from vct_torch.data import videodec

            return videodec.decode_video_native(
                path, height, width, max_frames,
                resize="cv2" if has_cv2 else "native",
            )
    import cv2

    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise IOError(f"Could not open video file {path}")
    frames: List[np.ndarray] = []
    while max_frames is None or len(frames) < max_frames:
        ret, frame = cap.read()
        if not ret:
            break
        frame = cv2.resize(frame, (width, height))
        if to_rgb:
            frame = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
        frames.append(frame)
    cap.release()
    return frames


def decode_uniform_seek(
    path: str, height: int, width: int, sequence_length: int
) -> List[np.ndarray]:
    """Decode ONLY the T frames uniform sampling selects, by seeking
    (CAP_PROP_POS_FRAMES to i * (total // T)).

    The same indices as ``uniform_sampling``, so the result matches the
    decode-everything path wherever the container seeks frame-accurately.
    Returns [] when the video is shorter than T or a seek fails (the caller
    falls back)."""
    import cv2

    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise IOError(f"Could not open video file {path}")
    try:
        total = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        if total < sequence_length or total <= 0:
            return []
        interval = total // sequence_length
        frames: List[np.ndarray] = []
        for i in range(sequence_length):
            cap.set(cv2.CAP_PROP_POS_FRAMES, i * interval)
            ret, frame = cap.read()
            if not ret:
                return []  # inaccurate metadata or seek: fall back
            frame = cv2.resize(frame, (width, height))
            frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
        return frames
    finally:
        cap.release()


def decode_and_sample(
    path: str,
    height: int,
    width: int,
    sequence_length: int,
    sampling_method: str = "uniform",
    normalize: bool = True,
    decoder: str = "cv2",
) -> np.ndarray:
    """One clip's host pipeline: decode -> sample -> pad -> (T, H, W, 3).

    Returns float32 in [0, 1] when ``normalize`` (the reference's /255) and
    uint8 otherwise (the clip cache's, normalized later on the device).
    """
    from vct_torch.data.samplers import sample_frames

    if sampling_method == "uniform_seek":
        # Seek-decode only the T frames; short clips, failed seeks and
        # cv2-free hosts fall back to the full decode.
        try:
            frames = decode_uniform_seek(path, height, width, sequence_length)
        except ImportError:
            frames = []
        if frames:
            clip = np.stack(frames).astype(np.float32 if normalize else np.uint8)
            if normalize:
                clip /= 255.0
            return clip
        sampling_method = "uniform"

    frames = decode_video(path, height, width, decoder=decoder)
    if not frames:
        raise ValueError(f"No frames found in {path}")
    frames = sample_frames(frames, sequence_length, sampling_method)
    clip = np.stack(frames).astype(np.float32 if normalize else np.uint8)
    if normalize:
        clip /= 255.0
    return clip


def _decode_one(args) -> Tuple[str, Optional[np.ndarray], str]:
    path, h, w, t, method, normalize, decoder = args
    try:
        return path, decode_and_sample(path, h, w, t, method, normalize, decoder), ""
    except Exception as e:  # a bad file is skipped and reported, as in the reference
        return path, None, str(e)


class ParallelDecoder:
    """Process-pool decode with a bounded in-flight window."""

    def __init__(self, workers: int = 4, decoder: str = "cv2"):
        self.workers = max(1, workers)
        self.decoder = decoder

    def decode_many(
        self,
        paths: Iterable[str],
        height: int,
        width: int,
        sequence_length: int,
        sampling_method: str = "uniform",
        normalize: bool = True,
        on_error=None,
    ):
        """Yields (path, clip) in input order, skipping the files that fail
        (each reported to ``on_error(path, message)``, else printed)."""
        jobs = [
            (p, height, width, sequence_length, sampling_method, normalize,
             self.decoder)
            for p in paths
        ]

        def emit(path, clip, err):
            if clip is None:
                if on_error is not None:
                    on_error(path, err)
                else:
                    print(f"Error processing {os.path.basename(path)}: {err}")
                return None
            return path, clip

        if self.workers == 1 or len(jobs) <= 1:
            for job in jobs:
                out = emit(*_decode_one(job))
                if out is not None:
                    yield out
            return

        # At most workers*4 decoded clips wait ahead of the consumer (a
        # float32 clip is MBs); results come in input order; the pool is
        # always shut down.
        window = self.workers * 4
        ctx = multiprocessing.get_context("spawn")
        with ProcessPoolExecutor(max_workers=self.workers, mp_context=ctx) as pool:
            pending = deque()
            job_iter = iter(jobs)
            for job in job_iter:
                pending.append(pool.submit(_decode_one, job))
                if len(pending) >= window:
                    break
            while pending:
                out = emit(*pending.popleft().result())
                nxt = next(job_iter, None)
                if nxt is not None:
                    pending.append(pool.submit(_decode_one, nxt))
                if out is not None:
                    yield out
