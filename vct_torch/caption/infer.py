"""Caption inference over a directory of videos: the port of
``vct/caption/infer.py`` for checkpoint directories.

The reference decodes eval clips one by one in host Python and prints
``Generated Caption: ...`` per video (``s2vt/beam_search.py:552-570``).
Point ``caption_directory`` at a trained vct_torch caption checkpoint
directory and a directory of videos: clips decode on the host in chunks
(``chunk`` clips resident at a time), each chunk goes to the device on its
own and is beam-searched there. ``vct``'s compiled ``.vctaot`` caption
artifacts are not ported (ROADMAP Queue 1 item 7 (b)): a file as
``model_path`` raises ``ValueError``.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np

__all__ = ["caption_directory", "VIDEO_EXTS"]

VIDEO_EXTS = (".mp4", ".avi", ".mov", ".mkv", ".webm")


def _list_videos(video_dir: str, video_ext: Optional[str]) -> List[str]:
    exts = (video_ext.lower(),) if video_ext else VIDEO_EXTS
    return sorted(os.path.join(video_dir, f) for f in os.listdir(video_dir)
                  if f.lower().endswith(exts))


def _skip_errors():
    """Per-file decode failures worth skipping. cv2.error subclasses
    Exception directly: without it, one corrupt stream that opens and then
    raises inside cv2 would abort the whole directory."""
    errs = (ValueError, OSError, RuntimeError)
    try:
        import cv2

        return errs + (cv2.error,)
    except ImportError:
        return errs


def _decode_chunk(paths: List[str], num_frames: int, size: int):
    """(clips f32 in [0, 1], kept paths): an unreadable file is skipped with
    a print. Only per-file decode failures are skipped; systemic errors (cv2
    missing, out of memory, Ctrl-C) propagate, or a broken host would print
    one error a video and exit 0 having captioned nothing."""
    from vct_torch.caption.data import extract_frames_interval

    clips, kept = [], []
    for p in paths:
        try:
            clips.append(extract_frames_interval(p, num_frames, size))
        except _skip_errors() as e:
            print(f"Error processing {os.path.basename(p)}: {e}")
            continue
        kept.append(p)
    return clips, kept


def _decode_chunk_raw(paths: List[str], raw_len: int, size: int, target_frames: int):
    """(raw uint8 clips padded to ``raw_len``, true lengths, kept paths):
    the host half of ``vct``'s raw caption-artifact contract, with
    ``_decode_chunk``'s skipping. ``target_frames`` lets a video over
    capacity fall back to host interval extraction
    (``extract_frames_raw``)."""
    from vct_torch.caption.data import extract_frames_raw

    raws, lens, kept = [], [], []
    for p in paths:
        try:
            fr = extract_frames_raw(p, raw_len, size, target_frames=target_frames)
        except _skip_errors() as e:
            print(f"Error processing {os.path.basename(p)}: {e}")
            continue
        lens.append(len(fr))
        if len(fr) < raw_len:
            fr = np.concatenate([fr, np.zeros((raw_len - len(fr), size, size, 3), np.uint8)])
        raws.append(fr)
        kept.append(p)
    return raws, lens, kept


def caption_directory(model_path: str, video_dir: str, beam_width: Optional[int] = None,
                      video_ext: Optional[str] = None, height: Optional[int] = None,
                      width: Optional[int] = None, chunk: Optional[int] = None,
                      device=None) -> List[Tuple[str, str]]:
    """Caption every video in ``video_dir`` on ``device`` (default: the
    card); returns [(path, caption), ...] and prints the reference's
    ``Generated Caption:`` line per video.

    ``model_path`` is a vct_torch caption checkpoint directory (its manifest
    holds config and vocab). Geometry defaults to the reference's 224x224
    and must be square (the frame extractor resizes square). ``chunk``
    (default 8) bounds the clips decoded and on the device at once. Raises
    ``FileNotFoundError`` for a missing ``model_path``, ``ValueError`` for
    no matching videos or a file as ``model_path`` (a ``.vctaot`` artifact,
    not ported), ``RuntimeError`` when every file was skipped."""
    paths = _list_videos(video_dir, video_ext)
    if not paths:
        raise ValueError(f"no videos matching {video_ext or VIDEO_EXTS} in {video_dir}")
    if not os.path.exists(model_path):
        raise FileNotFoundError(f"{model_path}: no such file or directory (expected a caption "
                                "checkpoint directory)")
    if os.path.isfile(model_path):
        raise ValueError(f"{model_path}: a .vctaot caption artifact is not ported to vct_torch "
                         "yet (ROADMAP Queue 1 item 7 (b)); pass a vct_torch caption "
                         "checkpoint directory")
    from vct_torch.caption.train import restore_caption_trainer

    height = 224 if height is None else height
    width = 224 if width is None else width
    if height != width:
        raise ValueError(f"geometry {height}x{width} is not square; the host frame extractor "
                         "(extract_frames_interval) resizes square")
    trainer, state, cfg = restore_caption_trainer(model_path, device=device)
    chunk = 8 if chunk is None else chunk

    results: List[Tuple[str, str]] = []
    for start in range(0, len(paths), chunk):
        clips, kept = _decode_chunk(paths[start : start + chunk], cfg.num_frames, height)
        if not clips:
            continue
        # One chunk on the device at a time (caption_videos copies it there).
        word_lists = trainer.caption_videos(state, np.stack(clips), beam_width=beam_width)
        for p, words in zip(kept, word_lists):
            text = " ".join(words)
            print(f"{os.path.basename(p)} Generated Caption: {text}")
            results.append((p, text))
    if not results:
        # Every file was skipped: a directory of corrupt videos must not exit
        # 0 having captioned nothing.
        raise RuntimeError(f"all {len(paths)} videos in {video_dir} failed to decode")
    return results
