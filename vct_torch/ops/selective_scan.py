"""K3: the Mamba selective scan, forward and backward.

Port of ``vct/ops/selective_scan_pallas.py::selective_scan_pallas`` (the TPU
kernel ``_scan_kernel``). The CUDA kernel is
``vct_torch/csrc/selective_scan.cu``; its note says what bounds it on the
H100 (the L-step chain and the launch at the deployed shape, the expf rate
at VideoMamba's) and how its design meets that: a channel's states spread
across lanes, S states a lane, by a plan chosen from the shapes
(``plan``). Any N.

The backward is ``selective_scan_bwd``, one launch of the kernel of
``vct_torch/csrc/selective_scan_bwd.cu`` (the forward's layout under a plan
of its own, ``bwd_plan``; each chunk's h recomputed into shared memory and
walked backwards; the sums over channels and batch added by the last block
to arrive, in a fixed order, so two runs are bit-equal); ``vct`` has no
Pallas kernel there (its custom_vjp differentiates the associative scan).
Where no input requires a gradient, ``selective_scan`` calls the registered
operator ``vct_torch::selective_scan``, whose CPU implementation is the
plain PyTorch version ``selective_scan_ref`` and whose CUDA implementation
is the forward kernel; an exported program calls the same operator. Where
one does, a CPU tensor goes to ``selective_scan_ref``, which autograd
differentiates, and a CUDA tensor to an autograd node whose forward is the
kernel and whose backward launches ``selective_scan_bwd``.
``selective_scan_bwd`` takes a CPU tensor to ``selective_scan_bwd_ref`` and
a CUDA tensor to its kernel.
"""

from __future__ import annotations

import functools

import torch

from vct_torch.ops import _build

__all__ = ["bwd_plan", "plan", "selective_scan", "selective_scan_bwd", "selective_scan_bwd_ref",
           "selective_scan_ref"]

_MAX_GRID_Y = 65535


def _validate(u, delta, A, B, C) -> None:
    if u.dim() != 3 or delta.shape != u.shape:
        raise ValueError(
            f"selective_scan wants u, delta of one (B, L, D) shape, got "
            f"{tuple(u.shape)} and {tuple(delta.shape)}"
        )
    batch, L, D = u.shape
    if A.dim() != 2 or A.shape[0] != D:
        raise ValueError(f"selective_scan wants A of shape (D={D}, N), got {tuple(A.shape)}")
    N = A.shape[1]
    for name, t in (("B", B), ("C", C)):
        if tuple(t.shape) != (batch, L, N):
            raise ValueError(
                f"selective_scan wants {name} of shape {(batch, L, N)}, got {tuple(t.shape)}"
            )


def selective_scan_ref(u, delta, A, B, C, reverse: bool = False) -> torch.Tensor:
    """Plain PyTorch version: the recurrence as a loop over time.

    u, delta: (B, L, D); A: (D, N), negative; B, C: (B, L, N). Returns
    (B, L, D). ``reverse`` flips only u and delta (B and C keep forward
    time order) and flips y back.
    """
    _validate(u, delta, A, B, C)
    if reverse:
        u = torch.flip(u, dims=(1,))
        delta = torch.flip(delta, dims=(1,))
    batch, L, D = u.shape
    h = torch.zeros((batch, D, A.shape[1]), dtype=u.dtype, device=u.device)
    ys = []
    for t in range(L):
        dA = torch.exp(delta[:, t, :, None] * A)
        h = dA * h + (delta[:, t] * u[:, t])[:, :, None] * B[:, t, None, :]
        ys.append((h * C[:, t, None, :]).sum(-1))
    y = torch.stack(ys, dim=1) if ys else torch.zeros_like(u)
    if reverse:
        y = torch.flip(y, dims=(1,))
    return y


def decode_plan(code: int, N: int, chunk_unit: int = 32) -> dict:
    """A plan as ``vct_scan_plan`` packs it (S | lanes << 4 | threads / 64 <<
    16 | chunk / 32 << 20), or ``vct_scan_bwd_plan`` with ``chunk_unit`` 8
    (chunk / 8 << 20), with the state tiles it walks for N states."""
    S, lanes = code & 15, (code >> 4) & 4095
    return {
        "states_per_lane": S,
        "lanes_per_channel": lanes,
        "warps_per_channel": max(1, lanes // 32),
        "state_tiles": max(1, -(-N // (lanes * S))),
        "block_threads": (code >> 16 & 15) * 64,
        "chunk_steps": (code >> 20 & 15) * chunk_unit,
    }


# Keyed on the shape alone, not the card: right on a node of identical cards
# (every rank and replica of a mesh reads one plan).
@functools.lru_cache(maxsize=None)
def plan_code(batch: int, D: int, N: int, states_per_lane: int = 0, block_threads: int = 0,
              chunk_steps: int = 0) -> int:
    """The packed plan the kernel library gives a batch of D channels of N
    states (decided by these shapes alone, so kept per shape); needs the
    built library. Each option at 0 is the library's choice, else it forces
    S = ``states_per_lane`` (1 or 2), blocks of ``block_threads`` (64, 128
    or 256) or chunks of at most ``chunk_steps`` (a multiple of 32 up to
    256), for timing one plan against another."""
    code = _build.load_kernels().vct_scan_plan(batch, D, N, states_per_lane, block_threads,
                                               chunk_steps)
    if code < 0:
        raise ValueError(f"selective_scan: no plan with S={states_per_lane}, "
                         f"{block_threads} threads, chunks of {chunk_steps}")
    return code


def plan(batch: int, D: int, N: int) -> dict:
    """How a CUDA launch spreads each of a batch of D channels' N states:
    states a lane, lanes and warps a channel, state tiles, the block's
    threads and the most steps a chunk, as the kernel library decides it
    (``vct_scan_plan``)."""
    return decode_plan(plan_code(batch, D, N), N)


# Keyed on the shape alone, not the card: right on a node of identical cards
# (every rank and replica of a mesh reads one plan).
@functools.lru_cache(maxsize=None)
def _bwd_layout(batch: int, L: int, D: int, N: int) -> tuple[int, int, int]:
    """The backward's packed plan, scratch floats and counters at a shape,
    as the kernel library decides them (by the shape alone, so kept)."""
    lib = _build.load_kernels()
    return tuple(f(batch, L, D, N) for f in (lib.vct_scan_bwd_plan,
                                             lib.vct_selective_scan_bwd_scratch,
                                             lib.vct_selective_scan_bwd_counters))


def bwd_plan(batch: int, L: int, D: int, N: int) -> dict:
    """How the backward kernel spreads each of a batch of D channels' N
    states over L steps (``vct_scan_bwd_plan``): states a lane, lanes and
    warps a channel, state tiles, the block's threads and the steps a chunk.
    Read-only: no plan can be forced."""
    return decode_plan(_bwd_layout(batch, L, D, N)[0], N, chunk_unit=8)


def _launch(u, delta, A, B, C, reverse: bool, code: int) -> torch.Tensor:
    """The kernel under the packed plan ``code``, no checks, no count."""
    batch, L, D = u.shape
    y = torch.empty_like(u)
    lib = _build.load_kernels()
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.vct_selective_scan_fwd(
            u.data_ptr(), delta.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(),
            y.data_ptr(), batch, L, D, A.shape[1], int(reverse), code, stream,
        )
    _build.check(lib, err, "selective_scan kernel launch")
    return y


def _check_cuda(name, tensors: dict) -> None:
    """Raise unless every tensor is an f32, contiguous CUDA tensor on one device."""
    first = next(iter(tensors.values()))
    if first.device.type != "cuda":
        raise RuntimeError(f"{name}: no kernel for device {first.device}")
    for tname, t in tensors.items():
        if t.device != first.device:
            raise ValueError(f"{name}: {tname} is on {t.device}, u on {first.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"the {name} kernel takes f32, {tname} is {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"the {name} kernel takes contiguous tensors, {tname} is not")
    if first.shape[0] > _MAX_GRID_Y:
        raise ValueError(f"the {name} kernel takes batch <= {_MAX_GRID_Y}, got {first.shape[0]}")


def _forward(u, delta, A, B, C, reverse: bool) -> torch.Tensor:
    """The counted forward launch on checked CUDA tensors."""
    if u.numel() == 0:
        return torch.empty_like(u)
    batch, L, D = u.shape
    y = _launch(u, delta, A, B, C, reverse, plan_code(batch, D, A.shape[1]))
    selective_scan.launches += 1
    return y


class _SelectiveScan(torch.autograd.Function):
    """The forward kernel, with the backward kernel as its gradient."""

    @staticmethod
    def forward(ctx, u, delta, A, B, C, reverse):
        ctx.save_for_backward(u, delta, A, B, C)
        ctx.reverse = reverse
        return _forward(u, delta, A, B, C, reverse)

    @staticmethod
    def backward(ctx, gy):
        grads = selective_scan_bwd(*ctx.saved_tensors, gy.contiguous(), reverse=ctx.reverse)
        return (*grads, None)


def selective_scan(u, delta, A, B, C, reverse: bool = False) -> torch.Tensor:
    """Drop-in for ``vct_torch.models.ssm.selective_scan`` (impl='pallas').

    On CUDA every input must be f32, contiguous and on u's device, and batch
    at most 65535; the kernel runs under ``plan``'s choice, or this raises.
    Where an input requires a gradient, the result's backward is
    ``selective_scan_bwd``.
    """
    _validate(u, delta, A, B, C)
    args = (u, delta, A, B, C)
    if u.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"selective_scan: no kernel for device {u.device}")
    if not (torch.is_grad_enabled() and any(t.requires_grad for t in args)):
        return torch.ops.vct_torch.selective_scan(*args, reverse)
    if u.device.type == "cpu":
        return selective_scan_ref(*args, reverse=reverse)
    _check_cuda("selective_scan", dict(zip(("u", "delta", "A", "B", "C"), args)))
    return _SelectiveScan.apply(*args, reverse)


@torch.library.custom_op("vct_torch::selective_scan", mutates_args=(), device_types="cpu")
def _op(u: torch.Tensor, delta: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
        C: torch.Tensor, reverse: bool) -> torch.Tensor:
    """The operator's CPU implementation: the plain version, uncounted."""
    return selective_scan_ref(u, delta, A, B, C, reverse=reverse)


@_op.register_kernel("cuda")
def _op_cuda(u, delta, A, B, C, reverse):
    """The operator's CUDA implementation: the checked, counted launch."""
    _validate(u, delta, A, B, C)
    _check_cuda("selective_scan", dict(zip(("u", "delta", "A", "B", "C"), (u, delta, A, B, C))))
    return _forward(u, delta, A, B, C, reverse)


@_op.register_fake
def _op_fake(u, delta, A, B, C, reverse):
    return u.new_empty(u.shape)


def selective_scan_bwd_ref(u, delta, A, B, C, gy, reverse: bool = False):
    """Plain version of the backward: autograd through ``selective_scan_ref``.
    Returns (du, ddelta, dA, dB, dC)."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (u, delta, A, B, C)]
        y = selective_scan_ref(*leaves, reverse=reverse)
        return torch.autograd.grad(y, leaves, gy)


def selective_scan_bwd(u, delta, A, B, C, gy, reverse: bool = False):
    """K3 backward: (du, ddelta, dA, dB, dC) of ``selective_scan(u, delta, A,
    B, C, reverse)`` against its output gradient gy (B, L, D). A CPU tensor
    goes to ``selective_scan_bwd_ref``; on CUDA the kernel runs, one launch
    under ``bwd_plan`` (the same checks as the forward), or this raises."""
    _validate(u, delta, A, B, C)
    if tuple(gy.shape) != tuple(u.shape):
        raise ValueError(f"selective_scan_bwd wants gy of shape {tuple(u.shape)}, "
                         f"got {tuple(gy.shape)}")
    if u.device.type == "cpu":
        return selective_scan_bwd_ref(u, delta, A, B, C, gy, reverse=reverse)
    tensors = dict(zip(("u", "delta", "A", "B", "C", "gy"), (u, delta, A, B, C, gy)))
    _check_cuda("selective_scan_bwd", tensors)
    batch, L, D = u.shape
    N = A.shape[1]
    grads = [torch.empty_like(t) for t in (u, delta, A, B, C)]
    if u.numel() == 0 or N == 0:
        return tuple(g.zero_() for g in grads)
    _, n_scratch, n_counters = _bwd_layout(batch, L, D, N)
    lib = _build.load_kernels()
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream().cuda_stream
        scratch = (torch.empty(n_scratch, dtype=torch.float32, device=u.device)
                   if n_scratch else None)
        counters = _build.counters(u.device, stream, n_counters) if n_counters else None
        err = lib.vct_selective_scan_bwd(
            *(t.data_ptr() for t in (u, delta, A, B, C, gy)),
            *(g.data_ptr() for g in grads),
            None if scratch is None else scratch.data_ptr(),
            None if counters is None else counters.data_ptr(),
            batch, L, D, N, int(reverse), stream,
        )
    _build.check(lib, err, "selective_scan_bwd kernel launch")
    selective_scan_bwd.launches += 1
    return tuple(grads)


selective_scan.launches = 0
selective_scan_bwd.launches = 0
