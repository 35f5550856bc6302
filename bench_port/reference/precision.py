"""Precision of the reference's parts: as the configuration states it, or,
for the control, one step below it.

A configuration states float32 (``compute_dtype``), with TF32 off: every
convolution and matrix product rounds nothing below float32. One step
below is TF32, whose products round their operands to 10 stored bits of
significand; here it is emulated by rounding the operands (``round_tf32``),
so it reads the same on any device. A head in bfloat16 runs under bfloat16
autocast.
"""

from __future__ import annotations

import contextlib

import torch

__all__ = ["check_stated", "tf32", "round_tf32", "operands", "head_context"]


def check_stated(cfg: dict) -> None:
    stated = cfg["model"].get("compute_dtype", "float32")
    if stated != "float32":
        raise ValueError(f"the reference computes float32 only, the configuration states "
                         f"{stated!r}")


@contextlib.contextmanager
def tf32(matmul: bool, cudnn: bool | None = None):
    """torch's TF32 flags as given inside the block, restored after it."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = matmul
    torch.backends.cudnn.allow_tf32 = matmul if cudnn is None else cudnn
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 ``t`` rounded to TF32's 10 stored bits of significand, to the
    nearest, ties to even (finite values)."""
    bits = t.float().contiguous().view(torch.int32)
    keep = (bits >> 13) & 1
    rounded = (bits + 0xFFF + keep) & ~0x1FFF
    return rounded.view(torch.float32)


def operands(x: torch.Tensor, w: torch.Tensor, kind: str):
    """The (input, weight) pair a product or convolution computes on."""
    if kind == "tf32":
        return round_tf32(x), round_tf32(w)
    return x, w


def head_context(device: torch.device, kind: str):
    """bfloat16 autocast for a head computed in bfloat16."""
    if kind == "bfloat16":
        return torch.autocast(device_type=device.type, dtype=torch.bfloat16)
    return contextlib.nullcontext()
