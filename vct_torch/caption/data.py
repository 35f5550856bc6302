"""Caption data: annotation parsing, caption encoding, frame extraction and
the batch loaders, the port of ``vct/caption/data.py``.

Annotation format: one "video_id caption..." line per pair
(``s2vt/beam_search.py:183-205`` preprocess_annotations). Clips decode to a
fixed ``num_frames`` x size x size via interval sampling with last-frame
padding (``beam_search.py:143-180`` extract_frames), in cv2's BGR order as
the reference reads them. Captions tokenize, wrap in <start>/<end>, and
pad/truncate to ``max_caption_len`` (``beam_search.py:103-141``). The
loaders follow the classifier's protocol (``vct_torch/data/loaders.py``):
exactly one ``rng.permutation`` per shuffled epoch, so a resumed run
fast-forwards the shuffle stream.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np

from vct_torch.caption.vocab import Vocabulary, tokenize_caption
from vct_torch.data.loaders import ArrayLoader, _pad

__all__ = ["preprocess_annotations", "encode_caption", "extract_frames_interval",
           "extract_frames_raw", "load_caption_dataset", "CaptionArrayLoader",
           "LazyCaptionLoader", "as_caption_loader"]


def preprocess_annotations(annotation_file: str) -> Tuple[List[Tuple[str, str]], List[str]]:
    """Returns ([(video_file, caption), ...], unique caption list).

    Captions dedupe in first-appearance order (not ``list(set(...))`` as in
    ``beam_search.py:183-205``): per-process string-hash salting makes set
    order nondeterministic, which would permute vocab ids between a run and
    its resume process."""
    annotations: List[Tuple[str, str]] = []
    sentences: List[str] = []
    seen = set()
    with open(annotation_file) as f:
        for line in f:
            line = line.strip()
            if not line:
                print("Warning: Empty line encountered.")
                continue
            split_index = line.find(" ")
            if split_index == -1:
                print(f"Warning: Line does not contain a space separator: {line}")
                continue
            caption = line[split_index + 1 :]
            annotations.append((line[:split_index], caption))
            if caption not in seen:
                seen.add(caption)
                sentences.append(caption)
    return annotations, sentences


def encode_caption(caption: str, vocab: Vocabulary, max_len: int) -> np.ndarray:
    ids = [vocab["<start>"]] + vocab.numericalize(tokenize_caption(caption)) + [vocab["<end>"]]
    if len(ids) >= max_len:
        ids = ids[:max_len]
    else:
        ids = ids + [vocab["<pad>"]] * (max_len - len(ids))
    return np.asarray(ids, np.int32)


def extract_frames_interval(path: str, target_frames: int = 30, size: int = 224,
                            as_uint8: bool = False) -> np.ndarray:
    """Interval frame extraction with last-frame padding
    (``beam_search.py:143-180``): every ``max(1, frame count //
    target_frames)``-th frame, resized to size x size and kept in cv2's BGR
    order. Returns (T, size, size, 3): float32 in [0, 1], divided on the
    host, or raw uint8 with ``as_uint8=True`` (the lazy loader's feed,
    divided on the device; the same values, since the reference resizes the
    uint8 frame before dividing)."""
    import cv2

    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise IOError(f"Could not open video file {path}")
    total = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    interval = max(1, total // target_frames)
    frames, count = [], 0
    while True:
        ret, frame = cap.read()
        if not ret or len(frames) >= target_frames:
            break
        if count % interval == 0:
            frames.append(cv2.resize(frame, (size, size)))
        count += 1
    cap.release()
    if not frames:
        raise ValueError(f"No frames found in {path}")
    while len(frames) < target_frames:
        frames.append(frames[-1])
    clip = np.stack(frames)
    return clip if as_uint8 else clip.astype(np.float32) / 255.0


def extract_frames_raw(path: str, max_frames: int, size: int = 224,
                       target_frames: Optional[int] = None) -> np.ndarray:
    """Every frame (up to ``max_frames``), resized, raw uint8 BGR
    (L, size, size, 3): the host half of ``vct``'s raw caption-artifact
    contract, whose interval selection and /255 run on the device.

    A video longer than ``max_frames`` exceeds the raw capacity. With
    ``target_frames`` given, it falls back to ``extract_frames_interval``
    over the whole video (uint8), so it captions as the pre-sampled path
    does; without, it is cut to its first ``max_frames`` frames with a
    printed warning."""
    from vct_torch.data.video import decode_video

    if target_frames is not None:
        import cv2

        cap = cv2.VideoCapture(path)
        if not cap.isOpened():
            raise IOError(f"Could not open video file {path}")
        total = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        cap.release()
        if total > max_frames:
            return extract_frames_interval(path, target_frames, size, as_uint8=True)
    # One frame past capacity, so a container whose frame count reads low
    # is still found over capacity.
    frames = decode_video(path, size, size, max_frames=max_frames + 1, to_rgb=False)
    if not frames:
        raise ValueError(f"No frames found in {path}")
    if len(frames) > max_frames:
        if target_frames is not None:
            return extract_frames_interval(path, target_frames, size, as_uint8=True)
        print(f"Warning: {os.path.basename(path)} exceeds the raw capacity "
              f"({max_frames} frames); striding over the first {max_frames} only")
        frames = frames[:max_frames]
    return np.stack(frames)


def load_caption_dataset(video_dir: str, annotation_file: str, vocab: Vocabulary,
                         num_frames: int = 30, max_caption_len: int = 30, size: int = 224,
                         video_ext: str = ".avi", limit: int = 0):
    """Every annotated clip decoded into memory: returns (clips (N, T, H, W,
    3) f32, captions (N, L) i32, the kept (video_id, caption) pairs). A
    file that fails to decode is skipped with a print."""
    annotations, _ = preprocess_annotations(annotation_file)
    if limit:
        annotations = annotations[:limit]
    clips, caps, kept = [], [], []
    for video_file, caption in annotations:
        path = os.path.join(video_dir, video_file + video_ext)
        try:
            clips.append(extract_frames_interval(path, num_frames, size))
        except Exception as e:
            print(f"Error processing {video_file}: {e}")
            continue
        caps.append(encode_caption(caption, vocab, max_caption_len))
        kept.append((video_file, caption))
    x = np.stack(clips) if clips else np.zeros((0, num_frames, size, size, 3), np.float32)
    y = np.stack(caps) if caps else np.zeros((0, max_caption_len), np.int32)
    return x, y, kept


class CaptionArrayLoader(ArrayLoader):
    """In-memory (clips, captions) batches: the classifier's ``ArrayLoader``
    contract, inherited."""

    def __init__(self, videos: np.ndarray, captions: np.ndarray, batch_size: int):
        super().__init__(np.asarray(videos), np.asarray(captions), batch_size)


def as_caption_loader(videos, captions=None, batch_size: int = 4):
    """Coerce (videos, captions) arrays or a loader-shaped object."""
    if hasattr(videos, "epoch") and hasattr(videos, "num_examples"):
        return videos
    if captions is None:
        raise TypeError(f"not a caption loader and no captions: {type(videos)!r}")
    return CaptionArrayLoader(videos, captions, batch_size)


class LazyCaptionLoader:
    """The out-of-core caption loader: each batch's clips decode from the
    video files at iteration time (the reference's ``VideoDataset.__getitem__``,
    ``s2vt/beam_search.py:91-118``), so resident memory is one batch at any
    dataset size. Clips come out uint8 (a quarter of the host-to-device
    copy); ``CaptionTrainer._prep_videos`` divides by 255 on the device.

    Captions encode once up front. A video file that does not exist is
    skipped with a print at construction; a clip whose decode fails
    mid-epoch (a corrupt file on disk) masks its batch row to 0 for the
    rest of the epoch, and the item drops from the dataset at the next
    ``epoch()`` call."""

    def __init__(self, video_dir: str, annotations, vocab: Vocabulary, batch_size: int = 4,
                 num_frames: int = 30, max_caption_len: int = 30, size: int = 224,
                 video_ext: str = ".avi", limit: int = 0):
        if isinstance(annotations, str):
            annotations, _ = preprocess_annotations(annotations)
        if limit:
            annotations = annotations[:limit]
        self.paths: List[str] = []
        self.annotations: List[Tuple[str, str]] = []
        caps = []
        for video_file, caption in annotations:
            path = os.path.join(video_dir, video_file + video_ext)
            if not os.path.exists(path):
                print(f"Error processing {video_file}: file not found")
                continue
            self.paths.append(path)
            self.annotations.append((video_file, caption))
            caps.append(encode_caption(caption, vocab, max_caption_len))
        self.captions = np.stack(caps) if caps else np.zeros((0, max_caption_len), np.int32)
        # Tokenized references in iteration order (BLEU eval).
        self._references = [[tokenize_caption(c)] for _, c in self.annotations]
        self.batch_size = batch_size
        self.num_frames, self.size = num_frames, size
        self.num_examples = len(self.paths)
        self._bad: set = set()  # indices whose decode failed this epoch

    @property
    def references(self):
        """BLEU references of what an eval pass decoded: items whose decode
        failed are left out (``CaptionTrainer.caption_videos`` drops their
        rows by the mask)."""
        if not self._bad:
            return self._references
        return [r for i, r in enumerate(self._references) if i not in self._bad]

    def _decode(self, i: int) -> np.ndarray:
        return extract_frames_interval(self.paths[i], self.num_frames, self.size, as_uint8=True)

    def _decode_safe(self, i: int):
        try:
            return self._decode(i)
        except Exception as e:  # a corrupt or truncated file: skip it
            if i not in self._bad:
                print(f"Error processing {os.path.basename(self.paths[i])}: {e}")
            self._bad.add(i)
            return None

    def _compact(self) -> None:
        """Drop for good the items whose decode failed in an earlier epoch."""
        if not self._bad:
            return
        keep = [i for i in range(self.num_examples) if i not in self._bad]
        self.paths = [self.paths[i] for i in keep]
        self.annotations = [self.annotations[i] for i in keep]
        self._references = [self._references[i] for i in keep]
        self.captions = self.captions[np.asarray(keep, np.int64)] if keep else self.captions[:0]
        self.num_examples = len(keep)
        self._bad = set()

    def peek(self) -> Tuple[np.ndarray, np.ndarray]:
        """(clip[1], caption[1]) of the first item that decodes."""
        for i in range(self.num_examples):
            clip = self._decode_safe(i)
            if clip is not None:
                return clip[None], self.captions[i : i + 1]
        raise ValueError(f"no decodable clips among {self.num_examples} item(s) — check "
                         "video_dir / video_ext (files may not match the annotation ids)")

    def epoch(self, rng=None):
        self._compact()
        order = rng.permutation(self.num_examples) if rng is not None \
            else np.arange(self.num_examples)
        blank = np.zeros((self.num_frames, self.size, self.size, 3), np.uint8)
        for start in range(0, self.num_examples, self.batch_size):
            idx = order[start : start + self.batch_size]
            rows, flags = [], []
            for i in idx:
                clip = self._decode_safe(i)
                rows.append(blank if clip is None else clip)
                flags.append(0.0 if clip is None else 1.0)
            if not any(flags):
                continue  # every clip of the batch failed
            xb, yb, mask = _pad(np.stack(rows), self.captions[idx], len(idx), self.batch_size)
            mask[: len(flags)] *= np.asarray(flags, np.float32)
            yield xb, yb, mask
