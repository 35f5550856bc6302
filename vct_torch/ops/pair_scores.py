"""K1: per-transition SAD / flow-proxy scores of consecutive integer frames.

Port of ``vct/ops/pair_scores_pallas.py::pair_scores`` (the TPU kernels
``_clip_kernel`` / ``_blocked_kernel``). The CUDA kernel is
``vct_torch/csrc/pair_scores.cu``; its note says what bounds it on the H100
(bytes: one read of every frame) and how its design meets that.

``pair_scores`` dispatches by device: a CPU tensor goes to the plain
PyTorch version ``pair_scores_ref``, a CUDA tensor to the kernel. Both sum
exactly in 64-bit integers and convert to f32 once, so sad is bit-exact
against the reference's int32 sum, and flow is the correctly rounded exact
sum (the reference accumulates flow in f32; agreement within rtol 1e-5).
"""

from __future__ import annotations

import math

import torch

from vct_torch.ops import _build

__all__ = ["pair_scores", "pair_scores_ref"]

_METHODS = ("sad", "flow")
_MAX_GRID_Y = 65535


def _validate(clips: torch.Tensor, method: str) -> None:
    if method not in _METHODS:
        raise KeyError(f"pair_scores supports sad|flow, got {method!r}")
    if clips.dtype.is_floating_point or clips.dtype.is_complex or clips.dtype == torch.bool:
        raise TypeError(
            f"pair_scores wants integer frames (got {clips.dtype}); the float "
            "path is vct_torch.data.samplers.device_frame_scores"
        )
    if clips.dim() != 5:
        raise ValueError(f"pair_scores wants (B, L, H, W, C) clips, got {tuple(clips.shape)}")


def pair_scores_ref(clips: torch.Tensor, method: str = "sad") -> torch.Tensor:
    """Plain PyTorch version: (B, L, H, W, C) integer -> (B, L-1) f32."""
    _validate(clips, method)
    B, L = clips.shape[:2]
    if L < 2:
        return torch.zeros((B, 0), dtype=torch.float32, device=clips.device)
    wide = torch.int64 if method == "flow" else torch.int32
    x = clips.reshape(B, L, -1).to(wide)
    d = x[:, 1:] - x[:, :-1]
    per = d * d if method == "flow" else d.abs()
    return per.sum(dim=-1, dtype=torch.int64).to(torch.float32)


def pair_scores(clips: torch.Tensor, method: str = "sad") -> torch.Tensor:
    """Per-transition change score of every consecutive frame pair, batched.

    clips: (B, L, H, W, C) integer frames. Returns (B, L-1) f32. On CUDA
    the clips must be uint8 and contiguous; the kernel runs or this raises.
    """
    _validate(clips, method)
    if clips.device.type == "cpu":
        return pair_scores_ref(clips, method)
    if clips.device.type != "cuda":
        raise RuntimeError(f"pair_scores: no kernel for device {clips.device}")
    if clips.dtype != torch.uint8:
        raise TypeError(f"the pair_scores kernel takes uint8 frames, got {clips.dtype}")
    if not clips.is_contiguous():
        raise ValueError("the pair_scores kernel takes contiguous clips")
    B, L = clips.shape[:2]
    frame_bytes = math.prod(clips.shape[2:])
    if B > _MAX_GRID_Y:
        raise ValueError(f"the pair_scores kernel takes at most {_MAX_GRID_Y} clips, got {B}")
    if B == 0 or L < 2 or frame_bytes == 0:
        return torch.zeros((B, max(L - 1, 0)), dtype=torch.float32, device=clips.device)
    out = torch.empty((B, L - 1), dtype=torch.float32, device=clips.device)
    lib = _build.load_kernels()
    with torch.cuda.device(clips.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.vct_pair_scores(
            clips.data_ptr(), out.data_ptr(), B, L, frame_bytes,
            int(method == "flow"), stream,
        )
    _build.check(lib, err, "pair_scores kernel launch")
    pair_scores.launches += 1
    return out


pair_scores.launches = 0
