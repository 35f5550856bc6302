"""On-device preprocessing: frame selection, normalization and resize.

Port of ``vct/data/preprocess.py``. The host stops at decoded uint8 frames;
everything after runs on the tensor's device:

    uint8 (B, L, H, W, 3)
      -> content-aware frame selection (SAD / SSIM / flow scores + top-k
         gather; integer frames are scored by the pair_scores and
         ssim_pair_scores kernels)
      -> f32 /255 normalize
      -> optional bilinear resize (cv2.INTER_LINEAR equivalent)
      -> (B, T, h, w, 3) model input
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from vct_torch.data.samplers import _device_ssim, device_frame_scores, device_topk_indices
from vct_torch.ops.pair_scores import pair_scores
from vct_torch.ops.ssim import ssim_pair_scores

__all__ = ["preprocess_clips", "device_sample_clips", "sample_indices"]


def _resize_bilinear(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """cv2.INTER_LINEAR-equivalent resize (half-pixel centers, no antialias)
    over the last three axes of float (..., H, W, C)."""
    lead, (H, W, C) = x.shape[:-3], x.shape[-3:]
    nchw = x.reshape((-1, H, W, C)).permute(0, 3, 1, 2)
    y = F.interpolate(nchw, size=(out_h, out_w), mode="bilinear", align_corners=False,
                      antialias=False)
    return y.permute(0, 2, 3, 1).reshape(lead + (out_h, out_w, C))


def preprocess_clips(
    raw: torch.Tensor,
    out_hw: Optional[Tuple[int, int]] = None,
    normalize: bool = True,
) -> torch.Tensor:
    """uint8 (B, T, H, W, 3) -> float32 model input."""
    x = raw.to(torch.float32)
    if normalize:
        x = x / 255.0
    if out_hw is not None and tuple(out_hw) != tuple(raw.shape[-3:-1]):
        x = _resize_bilinear(x, out_hw[0], out_hw[1])
    return x


def _ssim_scores(raw: torch.Tensor) -> torch.Tensor:
    """(B, L-1) ssim transition scores, 1 - mean SSIM of each pair."""
    if not raw.dtype.is_floating_point:
        return 1.0 - ssim_pair_scores(raw)
    Bn, L = raw.shape[:2]
    a = raw[:, :-1].to(torch.float32).reshape((Bn * (L - 1),) + raw.shape[2:])
    b = raw[:, 1:].to(torch.float32).reshape((Bn * (L - 1),) + raw.shape[2:])
    return 1.0 - _device_ssim(a, b).reshape(Bn, L - 1)


def sample_indices(
    raw: torch.Tensor,
    sequence_length: int,
    method: str = "sad",
    lengths: Optional[torch.Tensor] = None,
    short_pad: str = "cycle",
) -> torch.Tensor:
    """The (B, T) frame indices ``device_sample_clips`` gathers."""
    if short_pad not in ("cycle", "last"):
        raise ValueError(f"short_pad must be 'cycle' or 'last', got {short_pad!r}")
    Bn, L = raw.shape[0], raw.shape[1]
    dev = raw.device
    lens = (
        torch.as_tensor(lengths, device=dev).to(torch.int64)
        if lengths is not None
        else torch.full((Bn,), L, dtype=torch.int64, device=dev)
    )
    # Clips with true length n <= T keep all real frames, then pad: they are
    # never scored and never select padding.
    pos = torch.arange(sequence_length, device=dev)[None, :]
    n = lens.clamp(min=1)[:, None]
    cyc = pos % n if short_pad == "cycle" else torch.minimum(pos, n - 1)
    short = (lens <= sequence_length)[:, None]
    if L <= sequence_length:
        return cyc.expand(Bn, sequence_length)
    if method == "uniform":
        interval = (lens // sequence_length).clamp(min=1)
        idx = interval[:, None] * pos
        return torch.where(short, cyc, idx)
    if method == "ssim":
        scores = _ssim_scores(raw)
    elif raw.dtype.is_floating_point:
        scores = device_frame_scores(raw, method)
    else:
        scores = pair_scores(raw, method)
    # Transitions at or after the true end are padding: never selected.
    t = torch.arange(L - 1, device=dev)[None, :]
    scores = torch.where(t < (lens - 1)[:, None], scores, float("-inf"))
    # ssim keeps the canonical frame 0 + later frames; sad/flow the script's
    # earlier frames (see device_topk_indices).
    style = "canonical" if method == "ssim" else "script"
    idx = device_topk_indices(scores, sequence_length, style=style)
    return torch.where(short, cyc, idx)


def device_sample_clips(
    raw: torch.Tensor,
    sequence_length: int,
    method: str = "sad",
    out_hw: Optional[Tuple[int, int]] = None,
    lengths: Optional[torch.Tensor] = None,
    short_pad: str = "cycle",
) -> torch.Tensor:
    """(B, L, H, W, 3) clips with L >= T: select T frames per clip on the
    clips' device, then normalize and resize to ``out_hw``.

    ``lengths`` (B,) gives each clip's true frame count when L is padded up
    to a bucket size; the padded tail is masked out of selection. Clips
    shorter than T extend their real frames per ``short_pad``: "cycle"
    repeats cyclically (the classifier's ``duplicate_frames``), "last"
    repeats the final real frame (the caption pipeline's padding).

    Methods: "uniform" (stride selection, idx = (n // T) * arange(T));
    "sad" (exact) and "flow" (difference energy) keep the top-T
    transitions' earlier frames; "ssim" (1 - uniform-window SSIM) keeps
    frame 0 and the top-(T-1) transitions' later frames; all in temporal
    order.
    """
    idx = sample_indices(raw, sequence_length, method, lengths, short_pad)
    rows = torch.arange(raw.shape[0], device=raw.device)[:, None]
    return preprocess_clips(raw[rows, idx], out_hw=out_hw)
