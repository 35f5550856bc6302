"""K6: fused frame normalize, uint8 -> f32 ``(x * (1/255) - mean[c]) * inv_std[c]``.

Port of ``vct/ops/preprocess_pallas.py::normalize_frames_pallas`` (the TPU
kernel ``_norm_kernel``). The CUDA kernel is ``vct_torch/csrc/normalize.cu``;
its note says what bounds it on the H100 (bytes: one read of the uint8
input, one write of the f32 output) and how its design meets that.

As in ``vct``, no serving path calls it: ``preprocess_clips`` divides by 255,
where this multiplies by f32(1/255), and the two differ by an ulp on about
half the values.

``normalize_frames`` dispatches by device: a CPU tensor goes to the plain
PyTorch version ``normalize_frames_ref``, a CUDA tensor to the kernel. Both
take ``inv_std = 1/std`` in f32 and apply the same three f32 operations in
the same order, so they agree bit for bit.
"""

from __future__ import annotations

import torch

from vct_torch.ops import _build

__all__ = ["normalize_frames", "normalize_frames_ref"]

_SCALE = torch.tensor(1.0 / 255.0, dtype=torch.float32).item()  # f32(1/255), exactly


def _params(raw: torch.Tensor, mean, std):
    """Validate ``raw``; return the per-channel (C,) f32 mean and 1/std."""
    if raw.dtype.is_floating_point or raw.dtype.is_complex or raw.dtype == torch.bool:
        raise TypeError(f"normalize_frames wants integer frames, got {raw.dtype}")
    if raw.dim() < 3:
        raise ValueError(f"normalize_frames wants (..., H, W, C) frames, got {tuple(raw.shape)}")
    C = raw.shape[-1]

    def per_channel(v, fill):
        if v is None:
            return torch.full((C,), fill, dtype=torch.float32, device=raw.device)
        t = torch.as_tensor(v, dtype=torch.float32).to(raw.device).reshape(-1)
        if t.numel() != C:
            raise ValueError(f"normalize_frames wants {C} per-channel values, got {t.numel()}")
        return t

    return per_channel(mean, 0.0), 1.0 / per_channel(std, 1.0)


def normalize_frames_ref(raw: torch.Tensor, mean=None, std=None) -> torch.Tensor:
    """Plain PyTorch version: integer (..., H, W, C) -> f32 of the same shape.

    mean / std: optional per-channel (C,) values applied after the 1/255
    scale (the identity by default, as in ``vct``).
    """
    mean_t, inv_std = _params(raw, mean, std)
    return (raw.to(torch.float32) * _SCALE - mean_t) * inv_std


def normalize_frames(raw: torch.Tensor, mean=None, std=None) -> torch.Tensor:
    """uint8 (..., H, W, C) -> f32 ``(x * (1/255) - mean) * (1/std)``, fused.

    On CUDA the frames must be uint8 and contiguous; the kernel runs or
    this raises.
    """
    if raw.device.type == "cpu":
        return normalize_frames_ref(raw, mean, std)
    mean_t, inv_std = _params(raw, mean, std)
    if raw.device.type != "cuda":
        raise RuntimeError(f"normalize_frames: no kernel for device {raw.device}")
    if raw.dtype != torch.uint8:
        raise TypeError(f"the normalize_frames kernel takes uint8 frames, got {raw.dtype}")
    if not raw.is_contiguous():
        raise ValueError("the normalize_frames kernel takes contiguous frames")
    out = torch.empty(raw.shape, dtype=torch.float32, device=raw.device)
    if out.numel() == 0:
        return out
    lib = _build.load_kernels()
    with torch.cuda.device(raw.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.vct_normalize_frames(
            raw.data_ptr(), out.data_ptr(), raw.numel(), raw.shape[-1],
            mean_t.data_ptr(), inv_std.data_ptr(), _SCALE, stream,
        )
    _build.check(lib, err, "normalize_frames kernel launch")
    normalize_frames.launches += 1
    return out


normalize_frames.launches = 0
