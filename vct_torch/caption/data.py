"""Caption data: the annotation parser, caption encoding and the in-memory
batch loader, the port of part of ``vct/caption/data.py``.

Annotation format: one "video_id caption..." line per pair
(``s2vt/beam_search.py:183-205`` preprocess_annotations). Captions tokenize,
wrap in <start>/<end>, and pad/truncate to ``max_caption_len``
(``beam_search.py:103-141``). The loaders follow the classifier's protocol
(``vct_torch/data/loaders.py``): exactly one ``rng.permutation`` per
shuffled epoch, so a resumed run fast-forwards the shuffle stream.

The parts that decode video files (``LazyCaptionLoader``, the frame
extractors, ``load_caption_dataset``) are not ported yet (ROADMAP Queue 1
item 3).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from vct_torch.caption.vocab import Vocabulary, tokenize_caption
from vct_torch.data.loaders import ArrayLoader

__all__ = ["preprocess_annotations", "encode_caption", "CaptionArrayLoader", "as_caption_loader"]


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
