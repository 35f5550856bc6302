"""Checkpoints in a torch format: the port of ``vct/train/checkpoint.py``.

A model checkpoint (``save_checkpoint`` / ``load_checkpoint``):

    <dir>/weights.pt      the model's state_dict (tensors only, on the CPU)
    <dir>/manifest.json   framework, config dict, class names, metrics

as ``vct`` keeps its Orbax tree beside the same manifest, whose
``framework`` says which package wrote it ("vct_torch" here, "vct" there).
The full train state for resuming (``save_train_state`` /
``load_train_state``), in the same directory:

    <dir>/train_state.pt        the model's and the optimizer's state_dicts
                                (Adam's moments, the plateau-lowered learning
                                rate in ``param_groups``), the step count, the
                                dropout generator's state and its device type
    <dir>/train_manifest.json   framework, completed epochs, config, class
                                names and ``extra`` (the trainer's counters)

Every file is written to a temporary name and swapped in, so a crash
mid-save leaves the previous one; the train manifest is written last, so a
crash between the two swaps resumes from the newer state one epoch early
rather than pointing a manifest at a missing state. Loading checks every
tensor: a missing one raises ``KeyError``, an extra one or a wrong shape
``ValueError``, a directory another framework wrote ``ValueError``.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Mapping, Optional, Tuple

import torch
from torch import nn

from vct_torch.core.config import Config

__all__ = ["FRAMEWORK", "load_checkpoint", "load_train_state", "load_weights",
           "save_checkpoint", "save_train_state"]

FRAMEWORK = "vct_torch"
_MANIFEST = "manifest.json"
_WEIGHTS = "weights.pt"
_TRAIN_MANIFEST = "train_manifest.json"
_TRAIN_STATE = "train_state.pt"


def _atomic_save(obj, final: str) -> None:
    tmp = final + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, final)


def _atomic_json(obj, final: str) -> None:
    tmp = final + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f, indent=2)
    os.replace(tmp, final)


def _read_manifest(path: str, name: str) -> dict:
    with open(os.path.join(path, name)) as f:
        manifest = json.load(f)
    written_by = manifest.get("framework")
    if written_by != FRAMEWORK:
        hint = ("; converting a vct (Orbax) checkpoint to vct_torch is not ported yet "
                "(ROADMAP Queue 1 item 4)" if written_by == "vct" else "")
        raise ValueError(f"{path} was written by {written_by!r}, not {FRAMEWORK!r}{hint}")
    return manifest


@torch.no_grad()
def load_weights(model: nn.Module, state_dict: Mapping[str, torch.Tensor],
                 what: str = "checkpoint") -> nn.Module:
    """Copy ``state_dict`` into ``model`` (onto its device) after checking
    every tensor: one the model has and the dict lacks raises ``KeyError``;
    one the model does not have, or a shape mismatch, ``ValueError``."""
    own = model.state_dict()
    missing = sorted(set(own) - set(state_dict))
    if missing:
        raise KeyError(f"{what}: missing tensors {missing[:8]}")
    extra = sorted(set(state_dict) - set(own))
    if extra:
        raise ValueError(f"{what}: tensors the model does not have {extra[:8]}")
    for name, dst in own.items():
        if tuple(state_dict[name].shape) != tuple(dst.shape):
            raise ValueError(f"{what} shape mismatch at {name}: "
                             f"{tuple(state_dict[name].shape)} vs {tuple(dst.shape)}")
    model.load_state_dict(state_dict)
    return model


def save_checkpoint(path: str, state_dict: Dict[str, torch.Tensor], cfg: Config,
                    class_names: List[str], metrics: Optional[dict] = None) -> str:
    """Save a model's state_dict and the manifest under ``path``; returns
    the absolute path."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    _atomic_save({k: v.detach().to("cpu") for k, v in state_dict.items()},
                 os.path.join(path, _WEIGHTS))
    _atomic_json({
        "framework": FRAMEWORK,
        "config": cfg.to_dict(),
        "class_names": list(class_names),
        "metrics": metrics or {},
    }, os.path.join(path, _MANIFEST))
    return path


def load_checkpoint(path: str) -> Tuple[Dict[str, torch.Tensor], Config, List[str], dict]:
    """Returns (state_dict on the CPU, config, class names, manifest)."""
    path = os.path.abspath(path)
    manifest = _read_manifest(path, _MANIFEST)
    state_dict = torch.load(os.path.join(path, _WEIGHTS), map_location="cpu", weights_only=True)
    return state_dict, Config.from_dict(manifest["config"]), manifest["class_names"], manifest


def save_train_state(path: str, state, cfg: Config, class_names: List[str], epoch: int,
                     extra: Optional[dict] = None) -> str:
    """Save the full train state (``vct_torch.train.engine.TrainState``)
    after ``epoch`` completed epochs; ``extra`` is a small JSON-safe dict
    carried in the manifest (the early-stop and plateau counters, the epoch
    history), so a resumed run replays them."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    gen = state.generator
    _atomic_save({
        "model": state.model.state_dict(),
        "optimizer": state.optimizer.state_dict(),
        "step": int(state.step),
        "generator": None if gen is None else {"device": gen.device.type,
                                               "state": gen.get_state()},
    }, os.path.join(path, _TRAIN_STATE))
    _atomic_json({"framework": FRAMEWORK, "epoch": epoch, "config": cfg.to_dict(),
                  "class_names": list(class_names), "extra": extra or {}},
                 os.path.join(path, _TRAIN_MANIFEST))
    return path


def load_train_state(path: str, state) -> Tuple[object, int, dict]:
    """Restore a full train state into the freshly initialised ``state``, on
    its model's device whichever device saved it; returns (state, completed
    epochs, extra), or (state, 0, {}) where ``path`` holds no train
    manifest. A manifest without its state (an interrupted first save) warns
    and starts fresh. A dropout generator saved on another device type
    cannot continue there: it warns and keeps the fresh generator."""
    path = os.path.abspath(path)
    if not os.path.exists(os.path.join(path, _TRAIN_MANIFEST)):
        return state, 0, {}
    manifest = _read_manifest(path, _TRAIN_MANIFEST)
    state_file = os.path.join(path, _TRAIN_STATE)
    if not os.path.exists(state_file):
        print(f"warning: {path} has a train manifest but no {_TRAIN_STATE}; "
              "starting from epoch 0")
        return state, 0, {}
    saved = torch.load(state_file, map_location="cpu", weights_only=True)
    load_weights(state.model, saved["model"], "train state")
    state.optimizer.load_state_dict(saved["optimizer"])
    state.step = int(saved["step"])
    gen = saved["generator"]
    if state.generator is not None and gen is not None:
        if gen["device"] == state.generator.device.type:
            state.generator.set_state(gen["state"])
        else:
            print(f"warning: the dropout generator was saved on {gen['device']}; the "
                  f"{state.generator.device.type} generator keeps its seed")
    return state, int(manifest["epoch"]), manifest.get("extra", {})
