"""Model checkpoints in a torch format: the port of
``vct/train/checkpoint.py``'s ``save_checkpoint`` and ``load_checkpoint``.

    <dir>/weights.pt      the model's state_dict (tensors only, on the CPU)
    <dir>/manifest.json   framework, config dict, class names, metrics

as ``vct`` keeps its Orbax tree beside the same manifest, whose
``framework`` says which package wrote it ("vct_torch" here, "vct" there).
Both files are written to a temporary name and swapped in, so a crash
mid-save leaves the previous checkpoint. The full train state (resume) is
not ported yet (ROADMAP Queue 1 item 2).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

import torch

from vct_torch.core.config import Config

__all__ = ["FRAMEWORK", "load_checkpoint", "save_checkpoint"]

FRAMEWORK = "vct_torch"
_MANIFEST = "manifest.json"
_WEIGHTS = "weights.pt"


def save_checkpoint(path: str, state_dict: Dict[str, torch.Tensor], cfg: Config,
                    class_names: List[str], metrics: Optional[dict] = None) -> str:
    """Save a model's state_dict and the manifest under ``path``; returns
    the absolute path."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    weights = {k: v.detach().to("cpu") for k, v in state_dict.items()}
    tmp = os.path.join(path, _WEIGHTS + ".tmp")
    torch.save(weights, tmp)
    os.replace(tmp, os.path.join(path, _WEIGHTS))
    manifest = {
        "framework": FRAMEWORK,
        "config": cfg.to_dict(),
        "class_names": list(class_names),
        "metrics": metrics or {},
    }
    tmp = os.path.join(path, _MANIFEST + ".tmp")
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=2)
    os.replace(tmp, os.path.join(path, _MANIFEST))
    return path


def load_checkpoint(path: str) -> Tuple[Dict[str, torch.Tensor], Config, List[str], dict]:
    """Returns (state_dict on the CPU, config, class names, manifest)."""
    path = os.path.abspath(path)
    with open(os.path.join(path, _MANIFEST)) as f:
        manifest = json.load(f)
    if manifest.get("framework") != FRAMEWORK:
        raise ValueError(f"{path} was written by {manifest.get('framework')!r}, "
                         f"not {FRAMEWORK!r}")
    state_dict = torch.load(os.path.join(path, _WEIGHTS), map_location="cpu", weights_only=True)
    return state_dict, Config.from_dict(manifest["config"]), manifest["class_names"], manifest
