"""K3: the Mamba selective scan, forward.

Port of ``vct/ops/selective_scan_pallas.py::selective_scan_pallas`` (the TPU
kernel ``_scan_kernel``). The CUDA kernel is
``vct_torch/csrc/selective_scan.cu``; its note says what bounds it on the
H100 (the L-step chain and the launch at the deployed shape, the expf rate
at VideoMamba's) and how its design meets that: a channel's states spread
across lanes, S states a lane, by a plan chosen from the shapes
(``plan``). Any N. Forward only: the backward comes with the training slice.

``selective_scan`` dispatches by device: a CPU tensor goes to the plain
PyTorch version ``selective_scan_ref``, a CUDA tensor to the kernel.
"""

from __future__ import annotations

import functools

import torch

from vct_torch.ops import _build

__all__ = ["plan", "selective_scan", "selective_scan_ref"]

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


def decode_plan(code: int, N: int) -> dict:
    """A plan as ``vct_scan_plan`` packs it (S | lanes << 4 | threads / 64 <<
    16 | chunk / 32 << 20), with the state tiles it walks for N states."""
    S, lanes = code & 15, (code >> 4) & 4095
    return {
        "states_per_lane": S,
        "lanes_per_channel": lanes,
        "warps_per_channel": max(1, lanes // 32),
        "state_tiles": max(1, -(-N // (lanes * S))),
        "block_threads": (code >> 16 & 15) * 64,
        "chunk_steps": (code >> 20 & 15) * 32,
    }


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


def selective_scan(u, delta, A, B, C, reverse: bool = False) -> torch.Tensor:
    """Drop-in for ``vct_torch.models.ssm.selective_scan`` (impl='pallas').

    On CUDA every input must be f32, contiguous and on u's device, and batch
    at most 65535; the kernel runs under ``plan``'s choice, or this raises.
    """
    _validate(u, delta, A, B, C)
    if u.device.type == "cpu":
        return selective_scan_ref(u, delta, A, B, C, reverse=reverse)
    if u.device.type != "cuda":
        raise RuntimeError(f"selective_scan: no kernel for device {u.device}")
    tensors = {"u": u, "delta": delta, "A": A, "B": B, "C": C}
    for name, t in tensors.items():
        if t.device != u.device:
            raise ValueError(f"selective_scan: {name} is on {t.device}, u on {u.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"the selective_scan kernel takes f32, {name} is {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"the selective_scan kernel takes contiguous tensors, {name} is not")
    batch, L, D = u.shape
    if batch > _MAX_GRID_Y:
        raise ValueError(f"the selective_scan kernel takes batch <= {_MAX_GRID_Y}, got {batch}")
    if u.numel() == 0:
        return torch.empty_like(u)
    y = _launch(u, delta, A, B, C, reverse, plan_code(batch, D, A.shape[1]))
    selective_scan.launches += 1
    return y


selective_scan.launches = 0
