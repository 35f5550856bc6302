"""K4: mean uniform-window SSIM of every consecutive pair of integer frames.

Port of ``vct/ops/ssim_pallas.py::ssim_pair_scores`` (the TPU kernels
``_ssim_clip_kernel`` / ``_ssim_pair_kernel``, math in
``_ssim_chunk_scores``). The CUDA kernel is ``vct_torch/csrc/ssim.cu``; its
note says what bounds it on the H100 (instruction issue: the window sums and
the SSIM expression) and how its design meets that: a block takes a chunk of
K transitions and a band of R output rows, so each frame's window sums are
formed once per chunk. ``plan`` chooses (K, R, threads) from the shape.

``ssim_pair_scores`` calls the registered operator
``vct_torch::ssim_pair_scores``, whose CPU implementation is the plain
PyTorch version ``ssim_pair_scores_ref`` and whose CUDA implementation is
the kernel; an exported program calls the same operator. The
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

import functools

import torch

from vct_torch.ops import _build

__all__ = ["ssim_pair_scores", "ssim_pair_scores_ref", "plan", "KERNEL_WINDOWS"]

KERNEL_WINDOWS = (3,)  # the kernel's window sizes
_MAX_GRID_Y = 65535
MAX_CHUNK_PAIRS = 7  # K: the kernel has an instance for each K up to this
MAX_THREADS = 256
RAW_STAGES = 15  # the kernel's ring of input rows in shared memory (kStages)
# The row buffers' shared memory a block may take: 227 KB, the most a block
# may take, less 1 KB for the kernel's static reduction array.
SMEM_BYTES = 232448 - 1024
# Blocks the card holds at once: two 256-thread blocks on each of 132 SMs
# (``__launch_bounds__(256, 2)``).
RESIDENT_BLOCKS = 2 * 132
# The fewest blocks a plan gives where the shape allows: about two an SM,
# nine tenths of RESIDENT_BLOCKS. The plans timed fastest for one video
# (chip_smoke.py's ssim_pair_scores_plans) run 240-264 blocks, one wave;
# a floor of exactly two an SM pushed them into a second, part-filled wave.
MIN_BLOCKS = 9 * RESIDENT_BLOCKS // 10
# The plan's cost model, in instructions a thread (counted from the
# kernel's SASS): one frame's work at one input row (three shared-memory
# loads, the packed taps, the 3-tap and vertical sums, the moments), one
# pair's (a*b, covariance, numerator, denominator, division, f64 add), a
# row's loop and copies, and a block's fixed part (the reduction).
_FRAME_COST, _PAIR_COST, _ROW_COST, _BLOCK_COST = 14, 21, 20, 400


# Keyed on the shape alone, not the card: right on a node of identical cards
# (every rank and replica of a mesh reads one plan).
@functools.lru_cache(maxsize=None)
def plan(B: int, L: int, H: int, W: int, C: int, chunk_pairs: int = 0,
         band_rows: int = 0) -> dict:
    """How a CUDA launch cuts (B, L, H, W, C) uint8 clips: K =
    ``chunk_pairs`` transitions a block (one chunk), R = ``band_rows``
    output rows a block (one band; it reads R+2 input rows), ``threads`` a
    block, one output column a thread, the row's (W-2)*C columns taken a
    group of ``threads`` at a time.

    Each option at 0 is chosen: among the (K, R) whose blocks number at
    least ``MIN_BLOCKS`` (or every (pair, row) when there are fewer), the
    least modelled time, waves of resident blocks times a block's cost in
    instructions. A pure function of the shape; the kernel takes any plan
    this returns.
    """
    pairs, out_rows, WC = L - 1, H - 2, W * C
    if pairs < 1 or out_rows < 1 or W < 3 or C < 1:
        raise ValueError(f"ssim_pair_scores: no plan for L={L}, H={H}, W={W}, C={C}")
    threads = min(MAX_THREADS, -(-WC // 32) * 32)
    groups = -(-(WC - 2 * C) // threads)
    # RAW_STAGES input rows of the K+1 frames (K+2 at K=7: a bank-conflict
    # pad), each the threads + 2C bytes a column group reads, in 16-byte pieces
    row_bytes = -(-min(threads + 2 * C, WC) // 16) * 16

    def smem(K):
        return RAW_STAGES * row_bytes * (K + 1 + (K + 1) // 8)

    k_fit = min(MAX_CHUNK_PAIRS, pairs)
    while k_fit >= 1 and smem(k_fit) > SMEM_BYTES:
        k_fit -= 1
    if k_fit < 1 or chunk_pairs > k_fit or chunk_pairs < 0 or band_rows < 0:
        raise ValueError(f"ssim_pair_scores: no plan with K={chunk_pairs}, R={band_rows} "
                         f"for L={L}, H={H}, W={W}, C={C}")
    ks = [chunk_pairs] if chunk_pairs else range(1, k_fit + 1)
    rs = ([min(band_rows, out_rows)] if band_rows
          else sorted({-(-out_rows // n) for n in range(1, out_rows + 1)}))
    target = min(MIN_BLOCKS, B * pairs * out_rows)
    best = None
    for K in ks:
        for R in rs:
            blocks = B * -(-pairs // K) * -(-out_rows // R)
            if blocks < target and not (chunk_pairs and band_rows):
                continue
            block_cost = (groups * (R + 2) * ((K + 1) * _FRAME_COST + K * _PAIR_COST + _ROW_COST)
                          + _BLOCK_COST)
            # Full waves of resident blocks, then a partial one: as long where
            # it puts two blocks on some SM, half as long where each SM gets
            # at most one (a block alone has the SM's issue slots to itself).
            waves, rest = divmod(blocks, RESIDENT_BLOCKS)
            waves += 0 if rest == 0 else (1.0 if 2 * rest > RESIDENT_BLOCKS else 0.5)
            key = (waves * block_cost, blocks)
            if best is None or key < best[0]:
                best = (key, K, R, blocks)
    if best is None:  # one option forced, the other too coarse to fill the card
        K = chunk_pairs or 1
        R = min(band_rows, out_rows) or 1
        best = (None, K, R, B * -(-pairs // K) * -(-out_rows // R))
    _, K, R, blocks = best
    return {"chunk_pairs": K, "band_rows": R, "threads": threads,
            "chunks": -(-pairs // K), "bands": -(-out_rows // R), "blocks": blocks,
            "smem_bytes": smem(K)}


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
    if clips.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"ssim_pair_scores: no kernel for device {clips.device}")
    return torch.ops.vct_torch.ssim_pair_scores(clips, win, data_range)


@torch.library.custom_op("vct_torch::ssim_pair_scores", mutates_args=(), device_types="cpu")
def _op(clips: torch.Tensor, win: int, data_range: float) -> torch.Tensor:
    """The operator's CPU implementation: the plain version, uncounted."""
    return ssim_pair_scores_ref(clips, win, data_range)


@_op.register_kernel("cuda")
def _op_cuda(clips: torch.Tensor, win: int, data_range: float) -> torch.Tensor:
    """The operator's CUDA implementation: the checked, counted launch."""
    _validate(clips, win)
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
    out = _launch(clips, plan(B, L, H, W, C), _constants(win, data_range))
    ssim_pair_scores.launches += 1
    return out


@_op.register_fake
def _op_fake(clips: torch.Tensor, win: int, data_range: float) -> torch.Tensor:
    return clips.new_empty((clips.shape[0], torch.sym_max(clips.shape[1] - 1, 0)),
                           dtype=torch.float32)


def _launch(clips: torch.Tensor, p: dict, constants) -> torch.Tensor:
    """The kernel under plan ``p`` on contiguous uint8 CUDA clips, no
    checks, no count."""
    B, L, H, W, C = clips.shape
    out = torch.empty((B, L - 1), dtype=torch.float32, device=clips.device)
    lib = _build.load_kernels()
    with torch.cuda.device(clips.device):
        stream = torch.cuda.current_stream().cuda_stream
        partial = counter = None
        if p["bands"] > 1:
            partial = torch.empty((B, L - 1, p["bands"]), dtype=torch.float64,
                                  device=clips.device)
            counter = _build.counters(clips.device, stream, B * p["chunks"])
        err = lib.vct_ssim_pair_scores(
            clips.data_ptr(), out.data_ptr(),
            None if partial is None else partial.data_ptr(),
            None if counter is None else counter.data_ptr(),
            B, L, H, W * C, C, p["chunk_pairs"], p["band_rows"], p["threads"], *constants, stream,
        )
    _build.check(lib, err, "ssim_pair_scores kernel launch")
    return out


ssim_pair_scores.launches = 0
