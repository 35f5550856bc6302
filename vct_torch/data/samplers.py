"""Frame sampling: cyclic padding on the host, change scores and top-k on device.

Port of the parts of ``vct/data/samplers.py`` the serving path runs:

* ``duplicate_frames`` — cyclic repeat of a short clip up to T
* ``device_frame_scores`` — per-transition change scores of float or
  integer frames (sad, flow); the plain scorer for float frames
* ``device_topk_indices`` / ``device_select_topk`` — top-k selection with
  the reference's tie order (equal scores keep the lower index, as
  ``jax.lax.top_k`` does)

SSIM scoring is not ported yet (ROADMAP Queue 2, K4).
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

__all__ = [
    "duplicate_frames",
    "device_frame_scores",
    "device_topk_indices",
    "device_select_topk",
]

_SSIM_TODO = (
    "ssim scoring is not ported to vct_torch yet (ROADMAP Queue 2, K4: "
    "vct/ops/ssim_pallas.py::ssim_pair_scores)"
)


def duplicate_frames(frames: Sequence[np.ndarray], sequence_length: int) -> List[np.ndarray]:
    """Cyclic repeat to reach T; longer clips are cut to T."""
    frames = list(frames)
    if len(frames) >= sequence_length:
        return frames[:sequence_length]
    out: List[np.ndarray] = []
    while len(out) < sequence_length:
        out.extend(frames)
    return out[:sequence_length]


def device_frame_scores(clip: torch.Tensor, method: str = "sad") -> torch.Tensor:
    """Per-transition change scores of a (..., L, H, W, C) clip, in f32.

    Higher = more changed; returns (..., L-1) scores for transitions
    1..L-1. methods: sad | flow (the difference-energy proxy for Farneback
    magnitude). ``ssim`` raises ``NotImplementedError``.
    """
    if method == "ssim":
        raise NotImplementedError(_SSIM_TODO)
    if method not in ("sad", "flow"):
        raise KeyError(f"Unknown device score method: {method}")
    x = clip.to(torch.float32)
    d = x[..., 1:, :, :, :] - x[..., :-1, :, :, :]
    per = d.abs() if method == "sad" else d.square()
    return per.sum(dim=(-3, -2, -1))


def device_topk_indices(scores: torch.Tensor, sequence_length: int,
                        style: str = "canonical") -> torch.Tensor:
    """Sorted frame indices (..., T) from per-transition scores (..., L-1).

    ``style="canonical"`` (ssim): frame 0 + the top-(T-1) transitions'
    LATER frames. ``style="script"`` (sad/flow): the top-T transitions'
    EARLIER frames, no forced frame 0. Ties keep the lower index first.
    """
    order = torch.sort(scores, dim=-1, descending=True, stable=True).indices
    if style == "script":
        return torch.sort(order[..., :sequence_length], dim=-1).values
    later = order[..., : sequence_length - 1] + 1
    zero = torch.zeros(later.shape[:-1] + (1,), dtype=later.dtype, device=later.device)
    return torch.sort(torch.cat([zero, later], dim=-1), dim=-1).values


def device_select_topk(clip: torch.Tensor, scores: torch.Tensor,
                       sequence_length: int) -> torch.Tensor:
    """Select frame 0 + top-(T-1) transitions by score, temporal order.

    clip: (L, H, W, C); scores: (L-1,). Returns (T, H, W, C).
    """
    return clip[device_topk_indices(scores, sequence_length)]
