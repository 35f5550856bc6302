"""Selective-scan SSM (Mamba): the LRCN's temporal head.

Port of ``vct/models/ssm.py``: input projection, depthwise causal conv,
SiLU, (Δ, B, C) projection, Δ-discretisation, the diagonal first-order
recurrence

    h_t = exp(Δ_t ⊗ A) ⊙ h_{t-1} + (Δ_t ⊙ u_t) ⊗ B_t
    y_t = ⟨h_t, C_t⟩

and the SiLU-gated output projection, with the bidirectional variant (the
backward direction flips only u and Δ, as the reference does).

``selective_scan`` has three implementations: "associative" (log-depth
doubling scan, plain torch), "scan" (the sequential loop, which is the
kernel's plain version) and "pallas" (the hand-written CUDA kernel, K3; the
name is the reference's). The declared-but-unused ``D`` parameter is kept for
parameter parity and left out of the compute, as in the reference.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from vct_torch.models.layers import RMSNorm
from vct_torch.ops import selective_scan as _k3

__all__ = [
    "selective_scan",
    "causal_depthwise_conv1d",
    "ParallelMamba",
    "MambaResidualBlock",
]


def _associative_scan(u, delta, A, B, C):
    """Hillis-Steele inclusive scan of (a, b) pairs under
    (a_l, b_l) ∘ (a_r, b_r) = (a_l a_r, b_l a_r + b_r)."""
    a = torch.exp(delta[..., None] * A)  # (B, L, D, N)
    h = (delta * u)[..., None] * B[:, :, None, :]
    L = u.shape[1]
    off = 1
    while off < L:
        h = torch.cat([h[:, :off], h[:, :-off] * a[:, off:] + h[:, off:]], dim=1)
        a = torch.cat([a[:, :off], a[:, :-off] * a[:, off:]], dim=1)
        off *= 2
    return torch.einsum("bldn,bln->bld", h, C)


def selective_scan(u, delta, A, B, C, reverse: bool = False,
                   impl: str = "associative") -> torch.Tensor:
    """Diagonal selective scan; u, delta (B, L, D), A (D, N), B, C (B, L, N)
    -> y (B, L, D)."""
    if impl == "pallas":
        return _k3.selective_scan(u, delta, A, B, C, reverse=reverse)
    if impl == "scan":
        return _k3.selective_scan_ref(u, delta, A, B, C, reverse=reverse)
    if impl != "associative":
        raise ValueError(f"Unknown selective_scan impl: {impl}")
    if reverse:
        y = _associative_scan(torch.flip(u, dims=(1,)), torch.flip(delta, dims=(1,)), A, B, C)
        return torch.flip(y, dims=(1,))
    return _associative_scan(u, delta, A, B, C)


def _causal_conv(x, weight, bias):
    """x (B, L, D), weight (D, 1, k) -> (B, L, D): pad k-1 on both sides
    (torch ``Conv1d(groups=D, padding=k-1)``) and keep the first L outputs."""
    L, D = x.shape[1], x.shape[2]
    k = weight.shape[-1]
    y = F.conv1d(x.transpose(1, 2), weight, bias, padding=k - 1, groups=D)
    return y[..., :L].transpose(1, 2)


def causal_depthwise_conv1d(x: torch.Tensor, kernel: torch.Tensor,
                            bias: Optional[torch.Tensor]) -> torch.Tensor:
    """Depthwise causal conv over time: y[t] = sum_j w[j] * x[t-(k-1)+j].

    x: (B, L, D); kernel: (k, D) (the reference's layout); bias: (D,) or None.
    """
    return _causal_conv(x, kernel.t().unsqueeze(1).contiguous(), bias)


class ParallelMamba(nn.Module):
    """One selective-scan mixer."""

    def __init__(self, d_model: int, d_inner: int, n_state: int, dt_rank: int,
                 bias: bool = True, conv_bias: bool = True, kernel_size: int = 3,
                 bidirectional: bool = False, scan_impl: str = "associative"):
        super().__init__()
        self.n_state = n_state
        self.dt_rank = dt_rank
        self.bidirectional = bidirectional
        self.scan_impl = scan_impl
        self.A_log = nn.Parameter(torch.zeros(d_inner, n_state))
        self.D = nn.Parameter(torch.zeros(d_inner))  # declared, unused
        self.in_proj = nn.Linear(d_model, d_inner * 2, bias=bias)
        self.conv = nn.Conv1d(d_inner, d_inner, kernel_size, groups=d_inner,
                              padding=kernel_size - 1, bias=conv_bias)
        self.x_proj = nn.Linear(d_inner, dt_rank + 2 * n_state, bias=False)
        self.dt_proj = nn.Linear(dt_rank, d_inner, bias=True)
        width = d_inner * 2 if bidirectional else d_inner
        self.out_proj = nn.Linear(width, d_model, bias=bias)

    def forward(self, x):
        u, res = self.in_proj(x).chunk(2, dim=-1)
        u = F.silu(_causal_conv(u, self.conv.weight, self.conv.bias))
        dt, B, C = self.x_proj(u).split(
            [self.dt_rank, self.n_state, self.n_state], dim=-1
        )
        delta = F.softplus(self.dt_proj(dt))
        A = -torch.exp(self.A_log)
        # The kernel takes contiguous operands; B and C are views of x_proj.
        u, delta, B, C = (t.contiguous() for t in (u, delta, B, C))
        y = selective_scan(u, delta, A, B, C, reverse=False, impl=self.scan_impl)
        if self.bidirectional:
            y_bwd = selective_scan(u, delta, A, B, C, reverse=True, impl=self.scan_impl)
            y = torch.cat([y, y_bwd], dim=-1)
            res = torch.cat([res, res], dim=-1)
        return self.out_proj(y * F.silu(res))


class MambaResidualBlock(nn.Module):
    """Pre-RMSNorm residual wrapper: x + mixer(norm(x))."""

    def __init__(self, d_model: int, d_inner: int, n_state: int, dt_rank: int,
                 bias: bool = True, conv_bias: bool = True, kernel_size: int = 3,
                 bidirectional: bool = False, scan_impl: str = "associative"):
        super().__init__()
        self.mixer = ParallelMamba(
            d_model, d_inner, n_state, dt_rank, bias=bias, conv_bias=conv_bias,
            kernel_size=kernel_size, bidirectional=bidirectional, scan_impl=scan_impl,
        )
        self.norm = RMSNorm(d_model)

    def forward(self, x):
        return self.mixer(self.norm(x)) + x
