"""Frame sampling: the host samplers, and change scores and top-k on device.

Port of ``vct/data/samplers.py``. The host half is numpy, as in ``vct``, and
selects the same frames, ties included (the same stable ``np.argsort`` and
``sorted`` calls):

* ``uniform_sampling`` — stride = len//T, cut to T
* ``ssim_sampling`` — SSIM of consecutive frames (win 3, channel mean), frame
  0 + the T-1 lowest-similarity transitions' later frames, in order
* ``sad_sampling`` — sum of absolute differences, the top-T transitions'
  earlier frames (``_script_sampling``)
* ``optical_flow_sampling`` — Farneback flow magnitude where ``cv2``
  imports, the frame-difference energy where it does not; the same
  selection as SAD (``chip_smoke.py``'s files phase prints whether the
  host has cv2).
* ``ssim_sampling_most_unique`` / ``optical_flow_sampling_most_unique``
* ``duplicate_frames`` — cyclic repeat of a short clip up to T
* ``sample_frames`` — a ``SAMPLERS`` method, then padding to exactly T

``ssim_pair`` is skimage's ``structural_similarity(win_size=3 or 7,
channel_axis=-1)`` in numpy (uniform-filter statistics, channel mean, valid
crop); scikit-image is not a dependency.

The device half runs on torch tensors:

* ``device_frame_scores`` — per-transition change scores of float or
  integer frames (sad, flow, ssim); the plain scorer for float frames
* ``_device_ssim`` — batched mean SSIM with uniform windows, the float-frame
  SSIM scorer (integer frames take the ``ssim_pair_scores`` kernel)
* ``device_topk_indices`` / ``device_select_topk`` — top-k selection with
  the reference's tie order (equal scores keep the lower index, as
  ``jax.lax.top_k`` does)

torch is imported by the device functions, not by the module: the decode
workers of ``vct_torch.data.video`` import the host samplers and nothing of
torch.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, List, Sequence

import numpy as np

if TYPE_CHECKING:
    import torch

__all__ = [
    "uniform_sampling",
    "ssim_sampling",
    "sad_sampling",
    "optical_flow_sampling",
    "ssim_sampling_most_unique",
    "optical_flow_sampling_most_unique",
    "duplicate_frames",
    "sample_frames",
    "ssim_pair",
    "SAMPLERS",
    "device_frame_scores",
    "device_topk_indices",
    "device_select_topk",
]


# ----------------------------------------------------------------------
# SSIM (skimage-compatible, uniform filter, channel mean)


def _uniform_filter(x: np.ndarray, win: int) -> np.ndarray:
    """Mean over each win x win window, edges padded by repetition (the
    caller crops to the valid region)."""
    from numpy.lib.stride_tricks import sliding_window_view

    pad = win // 2
    xp = np.pad(x, ((pad, pad), (pad, pad)), mode="edge")
    w = sliding_window_view(xp, (win, win))
    return w.mean(axis=(-1, -2))


def ssim_pair(img1: np.ndarray, img2: np.ndarray, win_size: int = 3,
              data_range: float = 255.0) -> float:
    """Mean SSIM between two HxWxC uint8/float frames (channelwise mean)."""
    img1 = np.asarray(img1, np.float64)
    img2 = np.asarray(img2, np.float64)
    if img1.ndim == 2:
        img1, img2 = img1[..., None], img2[..., None]
    C1 = (0.01 * data_range) ** 2
    C2 = (0.03 * data_range) ** 2
    pad = (win_size - 1) // 2
    vals = []
    # skimage's default covariance: the sample one, N/(N-1)
    n = win_size * win_size
    cov_norm = n / (n - 1)
    for c in range(img1.shape[-1]):
        x, y = img1[..., c], img2[..., c]
        ux, uy = _uniform_filter(x, win_size), _uniform_filter(y, win_size)
        uxx = _uniform_filter(x * x, win_size)
        uyy = _uniform_filter(y * y, win_size)
        uxy = _uniform_filter(x * y, win_size)
        vx = cov_norm * (uxx - ux * ux)
        vy = cov_norm * (uyy - uy * uy)
        vxy = cov_norm * (uxy - ux * uy)
        a1, a2 = 2 * ux * uy + C1, 2 * vxy + C2
        b1, b2 = ux ** 2 + uy ** 2 + C1, vx + vy + C2
        s = (a1 * a2) / (b1 * b2)
        vals.append(s[pad:-pad or None, pad:-pad or None].mean())
    return float(np.mean(vals))


# ----------------------------------------------------------------------
# Host samplers (the reference's selection rules)


def uniform_sampling(frames: Sequence[np.ndarray], sequence_length: int):
    if len(frames) <= sequence_length:
        return list(frames)
    interval = len(frames) // sequence_length
    return [frames[i] for i in range(0, len(frames), interval)][:sequence_length]


def _score_based_sampling(frames, sequence_length, scores_low_is_selected):
    """Frame 0 + the (T-1) lowest-scoring transitions' LATER frames, in
    temporal order (the canonical loader's rule; ssim_sampling)."""
    order = np.argsort(scores_low_is_selected, kind="stable")
    selected = [0] + [int(i) + 1 for i in order[: sequence_length - 1]]
    selected = sorted(set(selected))[:sequence_length]
    return [frames[i] for i in selected]


def _script_sampling(frames, sequence_length, diffs_high_is_selected):
    """``sorted(np.argsort(differences)[-T:])``: the top-T transitions each
    give their EARLIER frame; frame 0 only when transition 0 ranks, the last
    frame never. The stable sort makes ties deterministic (the reference's
    scripts sort unstably), exactly as ``vct`` does."""
    order = np.argsort(diffs_high_is_selected, kind="stable")
    selected = sorted(int(i) for i in order[-sequence_length:])
    return [frames[i] for i in selected]


def ssim_sampling(frames: Sequence[np.ndarray], sequence_length: int):
    if len(frames) <= sequence_length:
        return list(frames)
    sims = np.array([
        ssim_pair(frames[i - 1], frames[i]) for i in range(1, len(frames))
    ])
    return _score_based_sampling(frames, sequence_length, sims)


def sad_sampling(frames: Sequence[np.ndarray], sequence_length: int):
    """Sum of absolute differences: high = most changed; selection by
    ``_script_sampling``."""
    if len(frames) <= sequence_length:
        return list(frames)
    sads = np.array([
        np.abs(np.asarray(frames[i], np.float64)
               - np.asarray(frames[i - 1], np.float64)).sum()
        for i in range(1, len(frames))
    ])
    return _script_sampling(frames, sequence_length, sads)


def _cv2():
    """The cv2 module, or None where it does not import."""
    try:
        import cv2
    except ImportError:
        return None
    return cv2


def optical_flow_sampling(frames: Sequence[np.ndarray], sequence_length: int):
    """Farneback flow-magnitude score, selection by ``_script_sampling``;
    the frame-difference energy where cv2 does not import."""
    if len(frames) <= sequence_length:
        return list(frames)
    cv2 = _cv2()
    scores = []
    for i in range(1, len(frames)):
        if cv2 is not None:
            prev = cv2.cvtColor(np.asarray(frames[i - 1]), cv2.COLOR_RGB2GRAY)
            curr = cv2.cvtColor(np.asarray(frames[i]), cv2.COLOR_RGB2GRAY)
            flow = cv2.calcOpticalFlowFarneback(
                prev, curr, None, 0.5, 3, 15, 3, 5, 1.2, 0
            )
            mag, _ = cv2.cartToPolar(flow[..., 0], flow[..., 1])
            scores.append(float(mag.sum()))
        else:
            d = np.asarray(frames[i], np.float64) - np.asarray(frames[i - 1], np.float64)
            scores.append(float(np.square(d).sum()))
    return _script_sampling(frames, sequence_length, np.asarray(scores))


def duplicate_frames(frames: Sequence[np.ndarray], sequence_length: int) -> List[np.ndarray]:
    """Cyclic repeat to reach T; longer clips are cut to T."""
    frames = list(frames)
    if len(frames) >= sequence_length:
        return frames[:sequence_length]
    out: List[np.ndarray] = []
    while len(out) < sequence_length:
        out.extend(frames)
    return out[:sequence_length]


def ssim_sampling_most_unique(frames: Sequence[np.ndarray], sequence_length: int):
    """Each middle frame scores max(|ssim(f, prev) - 1|, |ssim(f, next) - 1|)
    with skimage's default window (7); frame 0 always kept; the top scorers
    in temporal order."""
    if len(frames) <= sequence_length:
        return list(frames)
    scores = []
    for i in range(1, len(frames) - 1):
        before = ssim_pair(frames[i], frames[i - 1], win_size=7)
        after = ssim_pair(frames[i], frames[i + 1], win_size=7)
        scores.append((max(abs(before - 1), abs(after - 1)), i))
    scores.sort(reverse=True, key=lambda x: x[0])
    selected = {0}
    for _, idx in scores:
        if len(selected) >= sequence_length:
            break
        selected.add(idx)
    return [frames[i] for i in sorted(selected)[:sequence_length]]


def optical_flow_sampling_most_unique(frames: Sequence[np.ndarray], sequence_length: int):
    """The same transition scores as ``optical_flow_sampling``, under the
    reference's name for its most-unique flow variant."""
    return optical_flow_sampling(frames, sequence_length)


SAMPLERS = {
    "uniform": uniform_sampling,
    # The decoder reads only the T frames (vct_torch.data.video.
    # decode_uniform_seek); on decoded frames it is uniform selection.
    "uniform_seek": uniform_sampling,
    "ssim": ssim_sampling,
    "sad": sad_sampling,
    "optical_flow": optical_flow_sampling,
    "optiflow": optical_flow_sampling,
    "ssim_most_unique": ssim_sampling_most_unique,
    "optiflow_most_unique": optical_flow_sampling_most_unique,
}


def sample_frames(frames, sequence_length: int, method: str = "uniform"):
    """Sample + pad to exactly ``sequence_length`` frames."""
    try:
        sampler = SAMPLERS[method]
    except KeyError:
        raise KeyError(
            f"Unknown sampling method '{method}'. Available: {sorted(SAMPLERS)}"
        ) from None
    frames = sampler(frames, sequence_length)
    if len(frames) < sequence_length:
        frames = duplicate_frames(frames, sequence_length)
    return frames


# ----------------------------------------------------------------------
# Device-side scoring and selection (torch)


def device_frame_scores(clip: torch.Tensor, method: str = "sad") -> torch.Tensor:
    """Per-transition change scores of a (..., L, H, W, C) clip, in f32.

    Higher = more changed; returns (..., L-1) scores for transitions
    1..L-1. methods: sad | ssim (1 - mean SSIM, win 3) | flow (the
    difference-energy proxy for Farneback magnitude).
    """
    import torch

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
    import torch
    import torch.nn.functional as F

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
    import torch

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
