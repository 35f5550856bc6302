"""Shared layers: RMSNorm, the adapter MLP (canonical and DSL forms), heads.

Port of ``vct/models/layers.py``. Submodules carry the Flax names
(``adapt1``, ``bn1``, ``fc``, ``cell0_linear`` ...) so ``vct_torch.bridge``
maps weights mechanically. LayerNorm eps is 1e-5 and GELU is exact
throughout, as in the reference. Dropout draws its masks from the
generator its ``generator`` attribute names (the trainer seeds one from
``train.seed``), or from torch's default one; on a rank of a mesh it draws
the global batch's mask and keeps its rows.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from vct_torch.parallel.mesh import ambient_mesh

__all__ = [
    "RMSNorm",
    "Dropout",
    "CanonicalAdapter",
    "AdaptDSL",
    "MulticlassHead",
    "MultiBinaryHead",
    "parse_adapt_mode",
]

_LN_EPS = 1e-5


class RMSNorm(nn.Module):
    """x * rsqrt(mean(x^2) + eps) * w."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        var = x.to(torch.float32).square().mean(dim=-1, keepdim=True)
        return x * torch.rsqrt(var + self.eps).to(x.dtype) * self.weight


class Dropout(nn.Module):
    """Inverted dropout (``nn.Dropout``'s function) whose masks come from
    ``self.generator`` when one is set: a ``torch.Generator`` on the input's
    device. Identity in eval mode or at p = 0."""

    def __init__(self, p: float = 0.5):
        super().__init__()
        if not 0.0 <= p <= 1.0:
            raise ValueError(f"dropout probability must be in [0, 1], got {p}")
        self.p = p
        self.generator = None

    def forward(self, x):
        if not self.training or self.p == 0.0:
            return x
        if self.p == 1.0:
            return x * 0.0
        mesh = ambient_mesh()
        if mesh is not None and mesh.distributed and mesh.shape["data"] > 1:
            # A rank holds its data row's slice of the global batch: draw
            # the global batch's mask from the shared generator and keep
            # this rank's rows, so N ranks drop what one process would.
            n = x.shape[0]
            shape = (n * mesh.shape["data"],) + tuple(x.shape[1:])
            keep = torch.rand(shape, generator=self.generator, device=x.device) >= self.p
            keep = keep[mesh.data_index * n:(mesh.data_index + 1) * n]
        else:
            keep = torch.rand(x.shape, generator=self.generator, device=x.device) >= self.p
        return x * keep.to(x.dtype) / (1.0 - self.p)


class CanonicalAdapter(nn.Module):
    """x = drop(LN(gelu(W1 x)));  x = drop(LN(gelu(W2 x)));  x = LN(gelu(W3 x))

    with W1: F -> F/2, W2: F/2 -> F/4, W3: F/4 -> out_size.
    """

    def __init__(self, in_size: int, out_size: int, dropout: float = 0.25):
        super().__init__()
        f = in_size
        self.adapt1 = nn.Linear(f, f // 2)
        self.bn1 = nn.LayerNorm(f // 2, eps=_LN_EPS)
        self.adapt2 = nn.Linear(f // 2, f // 4)
        self.bn2 = nn.LayerNorm(f // 4, eps=_LN_EPS)
        self.adapt3 = nn.Linear(f // 4, out_size)
        self.bn3 = nn.LayerNorm(out_size, eps=_LN_EPS)
        self.drop = Dropout(dropout)

    def forward(self, x):
        x = self.drop(self.bn1(F.gelu(self.adapt1(x))))
        x = self.drop(self.bn2(F.gelu(self.adapt2(x))))
        return self.bn3(F.gelu(self.adapt3(x)))


_ACTS = {"g": F.gelu, "s": F.silu, "r": F.relu}


def parse_adapt_mode(mode: str) -> tuple[str, int]:
    """Split an adapter DSL string like "lnsd3" into (ops, depth).

    Trailing digits are the depth (default 3); the letters are the per-block
    op sequence (l=Linear, n=LayerNorm, g=GELU, s=SiLU, r=ReLU, d=Dropout).
    """
    digits = ""
    while mode and mode[-1].isdigit():
        digits = mode[-1] + digits
        mode = mode[:-1]
    depth = int(digits) if digits else 3
    for ch in mode:
        if ch not in "lngsrd":
            raise ValueError(f"Undefined layer type: {ch}")
    if "l" not in mode:
        raise ValueError(f"Adapt mode must contain a linear ('l'): {mode!r}")
    return mode, depth


class AdaptDSL(nn.Module):
    """Configurable adapter MLP from the string DSL.

    Sizes halve per block (``factor``) from in_size down, with the final
    linear mapping to ``out_size``.
    """

    def __init__(self, in_size: int, out_size: int, mode: str = "lnsd3",
                 dropout: float = 0.25, factor: int = 2):
        super().__init__()
        ops, depth = parse_adapt_mode(mode)
        sizes = [in_size]
        for _ in range(1, depth):
            sizes.append(sizes[-1] // factor)
        sizes.append(out_size)
        self.drop = Dropout(dropout)
        self._steps: list[tuple[str, str]] = []
        for i in range(len(sizes) - 1):
            width = sizes[i]
            for ch in ops:
                if ch == "l":
                    name = f"cell{i}_linear"
                    self.add_module(name, nn.Linear(width, sizes[i + 1]))
                    width = sizes[i + 1]
                elif ch == "n":
                    name = f"cell{i}_norm"
                    self.add_module(name, nn.LayerNorm(width, eps=_LN_EPS))
                else:
                    name = ""
                self._steps.append((ch, name))

    def forward(self, x):
        for ch, name in self._steps:
            if name:
                x = getattr(self, name)(x)
            elif ch == "d":
                x = self.drop(x)
            else:
                x = _ACTS[ch](x)
        return x


class MulticlassHead(nn.Module):
    """out = LN0(x); out = LNa(gelu(fc(out))); out = LNb(gelu(fca(out)));
    out = drop(out); logits = fcb(out)."""

    def __init__(self, in_size: int, num_classes: int, dropout: float = 0.25):
        super().__init__()
        f = in_size
        self.bn0 = nn.LayerNorm(f, eps=_LN_EPS)
        self.fc = nn.Linear(f, f // 2)
        self.bna = nn.LayerNorm(f // 2, eps=_LN_EPS)
        self.fca = nn.Linear(f // 2, f // 4)
        self.bnb = nn.LayerNorm(f // 4, eps=_LN_EPS)
        self.drop = Dropout(dropout)
        self.fcb = nn.Linear(f // 4, num_classes)

    def forward(self, x):
        x = self.bn0(x)
        x = self.bna(F.gelu(self.fc(x)))
        x = self.bnb(F.gelu(self.fca(x)))
        return self.fcb(self.drop(x))


class MultiBinaryHead(nn.Module):
    """Per-class binary logits as one Linear(F -> num_classes)."""

    def __init__(self, in_size: int, num_classes: int):
        super().__init__()
        self.binary_heads = nn.Linear(in_size, num_classes)

    def forward(self, x):
        return self.binary_heads(x)
