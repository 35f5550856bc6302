"""K3: the Mamba selective scan, forward.

Port of ``vct/ops/selective_scan_pallas.py::selective_scan_pallas`` (the TPU
kernel ``_scan_kernel``). The CUDA kernel is
``vct_torch/csrc/selective_scan.cu``; its note says what bounds it on the
H100 (the L-step dependency chain and launch latency at the serving shape)
and how its design meets that. Forward only: the backward comes with the
training slice.

``selective_scan`` dispatches by device: a CPU tensor goes to the plain
PyTorch version ``selective_scan_ref``, a CUDA tensor to the kernel.
"""

from __future__ import annotations

import torch

from vct_torch.ops import _build

__all__ = ["selective_scan", "selective_scan_ref", "KERNEL_N_STATES"]

KERNEL_N_STATES = (16, 32)  # the kernel's template instances
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


def selective_scan(u, delta, A, B, C, reverse: bool = False) -> torch.Tensor:
    """Drop-in for ``vct_torch.models.ssm.selective_scan`` (impl='pallas').

    On CUDA every input must be f32 and contiguous, and N one of
    ``KERNEL_N_STATES``; the kernel runs or this raises.
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
    N = A.shape[1]
    if N not in KERNEL_N_STATES:
        raise ValueError(
            f"the selective_scan kernel has instances for N in {KERNEL_N_STATES}, got N={N}"
        )
    if batch > _MAX_GRID_Y:
        raise ValueError(f"the selective_scan kernel takes batch <= {_MAX_GRID_Y}, got {batch}")
    y = torch.empty_like(u)
    if y.numel() == 0:
        return y
    lib = _build.load_kernels()
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.vct_selective_scan_fwd(
            u.data_ptr(), delta.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), y.data_ptr(), batch, L, D, N, int(reverse), stream,
        )
    _build.check(lib, err, "selective_scan kernel launch")
    selective_scan.launches += 1
    return y


selective_scan.launches = 0
