"""Device selection shared by the port's entry points."""

from __future__ import annotations

from typing import TYPE_CHECKING

if TYPE_CHECKING:
    import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names another.

    ``None`` means the card. Without CUDA that raises instead of quietly
    running on the CPU; pass ``device="cpu"`` to ask for the CPU. torch is
    imported here, not by the module: modules that the host decode workers
    import take this one without torch.
    """
    import torch

    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return dev
