"""Frame sampling: cyclic padding on the host, change scores and top-k on device.

Port of the parts of ``vct/data/samplers.py`` the serving path runs:

* ``duplicate_frames`` — cyclic repeat of a short clip up to T
* ``device_frame_scores`` — per-transition change scores of float or
  integer frames (sad, flow, ssim); the plain scorer for float frames
* ``_device_ssim`` — batched mean SSIM with uniform windows, the float-frame
  SSIM scorer (integer frames take the ``ssim_pair_scores`` kernel)
* ``device_topk_indices`` / ``device_select_topk`` — top-k selection with
  the reference's tie order (equal scores keep the lower index, as
  ``jax.lax.top_k`` does)
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

__all__ = [
    "duplicate_frames",
    "device_frame_scores",
    "device_topk_indices",
    "device_select_topk",
]

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
    1..L-1. methods: sad | ssim (1 - mean SSIM, win 3) | flow (the
    difference-energy proxy for Farneback magnitude).
    """
    if method not in ("sad", "flow", "ssim"):
        raise KeyError(f"Unknown device score method: {method}")
    x = clip.to(torch.float32)
    prev, curr = x[..., :-1, :, :, :], x[..., 1:, :, :, :]
    if method == "ssim":
        return 1.0 - _device_ssim(prev, curr)
    d = curr - prev
    per = d.abs() if method == "sad" else d.square()
    return per.sum(dim=(-3, -2, -1))


def _device_ssim(a: torch.Tensor, b: torch.Tensor, win: int = 3,
                 data_range: float = 255.0) -> torch.Tensor:
    """Batched mean SSIM over (..., H, W, C) float frame pairs with uniform
    windows; returns (...,).

    The window means are separable depthwise filters, one over H and then
    one over W, each a grouped ``conv2d`` with weights 1/win, as ``vct``'s
    ``_device_ssim`` runs them; the mean is over the valid region.
    """
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    n = win * win
    cov_norm = n / (n - 1)
    lead, (H, W, C) = a.shape[:-3], a.shape[-3:]

    def filt(x):
        x = x.reshape((-1, H, W, C)).permute(0, 3, 1, 2)  # NCHW view
        kh = torch.full((C, 1, win, 1), 1.0 / win, dtype=x.dtype, device=x.device)
        kw = torch.full((C, 1, 1, win), 1.0 / win, dtype=x.dtype, device=x.device)
        return F.conv2d(F.conv2d(x, kh, groups=C), kw, groups=C)

    ua, ub = filt(a), filt(b)
    uaa, ubb, uab = filt(a * a), filt(b * b), filt(a * b)
    va = cov_norm * (uaa - ua * ua)
    vb = cov_norm * (ubb - ub * ub)
    vab = cov_norm * (uab - ua * ub)
    s = ((2 * ua * ub + c1) * (2 * vab + c2)) / (
        (ua ** 2 + ub ** 2 + c1) * (va + vb + c2)
    )
    return s.mean(dim=(1, 2, 3)).reshape(lead)


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
