"""On-device preprocessing: frame selection and normalization.

Port of ``vct/data/preprocess.py``. The host stops at decoded uint8 frames;
everything after runs on the tensor's device:

    uint8 (B, L, H, W, 3)
      -> content-aware frame selection (SAD / flow scores + top-k gather;
         integer frames are scored by the pair_scores kernel)
      -> f32 /255 normalize
      -> (B, T, H, W, 3) model input

The bilinear resize (``out_hw``) is not ported yet: the serving path never
asks for it, and any other ``out_hw`` raises ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from vct_torch.data.samplers import _SSIM_TODO, device_frame_scores, device_topk_indices
from vct_torch.ops.pair_scores import pair_scores

__all__ = ["preprocess_clips", "device_sample_clips", "sample_indices"]


def _check_out_hw(out_hw, frame_hw) -> None:
    if out_hw is not None and tuple(out_hw) != tuple(frame_hw):
        raise NotImplementedError(
            "the bilinear resize (out_hw) is not ported to vct_torch yet "
            "(ROADMAP Queue 1)"
        )


def preprocess_clips(
    raw: torch.Tensor,
    out_hw: Optional[Tuple[int, int]] = None,
    normalize: bool = True,
) -> torch.Tensor:
    """uint8 (B, T, H, W, 3) -> float32 model input."""
    _check_out_hw(out_hw, raw.shape[-3:-1])
    x = raw.to(torch.float32)
    if normalize:
        x = x / 255.0
    return x


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
        raise NotImplementedError(_SSIM_TODO)
    if raw.dtype.is_floating_point:
        scores = device_frame_scores(raw, method)
    else:
        scores = pair_scores(raw, method)
    # Transitions at or after the true end are padding: never selected.
    t = torch.arange(L - 1, device=dev)[None, :]
    scores = torch.where(t < (lens - 1)[:, None], scores, float("-inf"))
    idx = device_topk_indices(scores, sequence_length, style="script")
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
    clips' device, then normalize.

    ``lengths`` (B,) gives each clip's true frame count when L is padded up
    to a bucket size; the padded tail is masked out of selection. Clips
    shorter than T extend their real frames per ``short_pad``: "cycle"
    repeats cyclically (the classifier's ``duplicate_frames``), "last"
    repeats the final real frame (the caption pipeline's padding).

    Methods: "uniform" (stride selection, idx = (n // T) * arange(T)),
    "sad" (exact) and "flow" (difference energy): score transitions, keep
    the top-T transitions' earlier frames in temporal order. "ssim" raises
    ``NotImplementedError``.
    """
    _check_out_hw(out_hw, raw.shape[-3:-1])
    idx = sample_indices(raw, sequence_length, method, lengths, short_pad)
    rows = torch.arange(raw.shape[0], device=raw.device)[:, None]
    return preprocess_clips(raw[rows, idx])
