"""K4: mean uniform-window SSIM of every consecutive pair of integer frames.

Port of ``vct/ops/ssim_pallas.py::ssim_pair_scores`` (the TPU kernels
``_ssim_clip_kernel`` / ``_ssim_pair_kernel``, math in
``_ssim_chunk_scores``). The CUDA kernel is ``vct_torch/csrc/ssim.cu``; its
note says what bounds it on the H100 (the ALU work of the five window
moments and the SSIM expression) and how its design meets that.

``ssim_pair_scores`` dispatches by device: a CPU tensor goes to the plain
PyTorch version ``ssim_pair_scores_ref``, a CUDA tensor to the kernel. The
plain version follows the TPU kernel's arithmetic, not the float scorer's
(``vct_torch.data.samplers._device_ssim``): a frame is an (H, W*C) array,
the five window sums are exact integer sums (every product and 3x3 sum of
uint8 values is an integer below 2**24), converted to f32 and multiplied by
f32(1/win**2), and the SSIM expression follows ``_ssim_chunk_scores`` term
by term. The per-pair mean is summed in f64 and rounded to f32 once, so its
summation order does not matter in practice: the kernel repeats every f32
operation unfused and agrees bit for bit.
"""

from __future__ import annotations

import torch

from vct_torch.ops import _build

__all__ = ["ssim_pair_scores", "ssim_pair_scores_ref", "KERNEL_WINDOWS"]

KERNEL_WINDOWS = (3,)  # the kernel's window sizes
_MAX_GRID_Y = 65535


def _validate(clips: torch.Tensor, win: int) -> None:
    if clips.dtype.is_floating_point or clips.dtype.is_complex or clips.dtype == torch.bool:
        raise TypeError(
            f"ssim_pair_scores wants integer frames (got {clips.dtype}); the "
            "f32 path is vct_torch.data.samplers._device_ssim"
        )
    if clips.dim() != 5:
        raise ValueError(f"ssim_pair_scores wants (B, L, H, W, C) clips, got {tuple(clips.shape)}")
    H, W = clips.shape[2:4]
    if clips.shape[1] >= 2 and (H < win or W < win):
        raise ValueError(f"frames {H}x{W} smaller than SSIM window {win}")


def _f32(x: float) -> float:
    """``x`` rounded to f32, as a Python float (exact in either type)."""
    return torch.tensor(x, dtype=torch.float32).item()


def _constants(win: int, data_range: float):
    """(inv_n, cov_norm, c1, c2) as the TPU kernel sees them: Python floats
    rounded to f32 where they meet f32 arrays."""
    n = win * win
    return (_f32(1.0 / n), _f32(n / (n - 1)),
            _f32((0.01 * data_range) ** 2), _f32((0.03 * data_range) ** 2))


def ssim_pair_scores_ref(clips: torch.Tensor, win: int = 3,
                         data_range: float = 255.0) -> torch.Tensor:
    """Plain PyTorch version: (B, L, H, W, C) integer -> (B, L-1) f32."""
    _validate(clips, win)
    B, L, H, W, C = clips.shape
    if L < 2:
        return torch.zeros((B, 0), dtype=torch.float32, device=clips.device)
    # 1-byte frames: squares and 3x3 sums fit int32; wider ints take int64.
    wide = torch.int32 if clips.element_size() == 1 else torch.int64
    x = clips.reshape(B, L, H, W * C).to(wide)
    a, b = x[:, :-1], x[:, 1:]
    n_rows, n_cols = H - win + 1, (W - win + 1) * C

    def win_sum(v):
        rows = sum(v[..., r:r + n_rows, :] for r in range(win))
        return sum(rows[..., c * C:c * C + n_cols] for c in range(win))

    inv_n, cov_norm, c1, c2 = _constants(win, data_range)
    ua = win_sum(a).to(torch.float32) * inv_n
    ub = win_sum(b).to(torch.float32) * inv_n
    uaa = win_sum(a * a).to(torch.float32) * inv_n
    ubb = win_sum(b * b).to(torch.float32) * inv_n
    uab = win_sum(a * b).to(torch.float32) * inv_n
    va = cov_norm * (uaa - ua * ua)
    vb = cov_norm * (ubb - ub * ub)
    vab = cov_norm * (uab - ua * ub)
    s = ((2.0 * ua * ub + c1) * (2.0 * vab + c2)) / (
        (ua * ua + ub * ub + c1) * (va + vb + c2)
    )
    total = s.to(torch.float64).sum(dim=(-2, -1))
    return (total / float(n_rows * n_cols)).to(torch.float32)


def ssim_pair_scores(clips: torch.Tensor, win: int = 3,
                     data_range: float = 255.0) -> torch.Tensor:
    """Mean SSIM of every consecutive frame pair, batched.

    clips: (B, L, H, W, C) integer frames. Returns (B, L-1) f32, SSIM of
    frame i against frame i+1. Float frames raise ``TypeError``, L < 2
    gives (B, 0), frames smaller than the window raise ``ValueError``. On
    CUDA the clips must be uint8 and contiguous and ``win`` one of
    ``KERNEL_WINDOWS``; the kernel runs or this raises.
    """
    _validate(clips, win)
    if clips.device.type == "cpu":
        return ssim_pair_scores_ref(clips, win, data_range)
    if clips.device.type != "cuda":
        raise RuntimeError(f"ssim_pair_scores: no kernel for device {clips.device}")
    if clips.dtype != torch.uint8:
        raise TypeError(f"the ssim_pair_scores kernel takes uint8 frames, got {clips.dtype}")
    if not clips.is_contiguous():
        raise ValueError("the ssim_pair_scores kernel takes contiguous clips")
    if win not in KERNEL_WINDOWS:
        raise ValueError(f"the ssim_pair_scores kernel has instances for win in "
                         f"{KERNEL_WINDOWS}, got {win}")
    B, L, H, W, C = clips.shape
    if B > _MAX_GRID_Y:
        raise ValueError(f"the ssim_pair_scores kernel takes at most {_MAX_GRID_Y} clips, got {B}")
    if B == 0 or L < 2:
        return torch.zeros((B, max(L - 1, 0)), dtype=torch.float32, device=clips.device)
    out = torch.empty((B, L - 1), dtype=torch.float32, device=clips.device)
    inv_n, cov_norm, c1, c2 = _constants(win, data_range)
    lib = _build.load_kernels()
    with torch.cuda.device(clips.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.vct_ssim_pair_scores(
            clips.data_ptr(), out.data_ptr(), B, L, H, W * C, C,
            inv_n, cov_norm, c1, c2, stream,
        )
    _build.check(lib, err, "ssim_pair_scores kernel launch")
    ssim_pair_scores.launches += 1
    return out


ssim_pair_scores.launches = 0
