"""A whole reference-LRCN torch state_dict into the port's LRCN: the port of
``vct/models/lrcn_port.py``.

The reference checkpoints whole torch modules (``train_eval.py:53``
``torch.save(model)``); a user exports ``torch.load(path).state_dict()``
and runs ``python -m vct_torch.tools.port_reference`` to get a vct_torch
checkpoint the serving path loads (``vct_torch.serve.deployment.load_model``).

The layout consumed (``medsos_lrcn/src/models.py:121-186``), and where each
part lands in the port's modules:

    cnn_backbone.*                        torchvision backbone (its porter)
    adapt{1,2,3}.*, bn{1,2,3}.*           adapt.adapt{1,2,3}, adapt.bn{1,2,3}
    rnn.weight_ih_l{i}[_reverse] ...      rnn.{lstm,gru}.* , weights transposed
                                          to the port's (in, G*H) layout
    rnn.{i}.norm.weight, rnn.{i}.mixer.*  mamba_{i}.norm, mamba_{i}.mixer
                                          (the mixer's ``conv1d`` is ``conv``)
    bn0/fc/bna/fca/bnb/fcb.*              head.* (multiclass MLP head)
    fc.{i}.weight/bias                    head.binary_heads, the per-class
                                          heads fused into one Linear

Strict: every tensor a porter reads is tracked per key, so a tensor no
porter touched (the ``*_reverse`` half of a bidirectional checkpoint ported
with ``bidirectional=False``) raises ``ValueError``, as does a shape that
does not match the model; a tensor the layout needs and the state_dict
lacks raises ``KeyError``. Nothing is written unless everything maps.
``port_reference_videomamba`` and ``port_reference_s2vt`` wait for their
models (ROADMAP Queue 1 items 5 and 6).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

from vct_torch.models.backbones.port import load_torch_backbone, torch_tensor_dict

__all__ = ["port_reference_lrcn", "port_reference_videomamba", "port_reference_s2vt"]


class _ConsumeTracker:
    """A state_dict that records exactly which keys are read, so the
    consume-everything check flags any tensor no porter touched."""

    def __init__(self, data: Dict[str, np.ndarray]):
        self.data = data
        self.consumed = set()

    def __getitem__(self, key):
        if key not in self.data:
            raise KeyError(f"Missing tensor in state_dict: {key}")
        self.consumed.add(key)
        return self.data[key]

    def consume_region(self, prefix: str) -> Dict[str, np.ndarray]:
        """Mark every key under ``prefix.`` consumed and return the sub-dict
        (for a sub-porter with its own strict per-key checks)."""
        sub = {}
        for k, v in self.data.items():
            if k.startswith(prefix + "."):
                self.consumed.add(k)
                sub[k[len(prefix) + 1:]] = v
        return sub

    def leftovers(self):
        return sorted(k for k in self.data
                      if k not in self.consumed and not k.endswith("num_batches_tracked"))


def _copy(out: Dict[str, np.ndarray], sd: _ConsumeTracker, ours: str, theirs: str,
          names=("weight", "bias")) -> None:
    for name in names:
        out[f"{ours}.{name}"] = sd[f"{theirs}.{name}"]


def _port_rnn(out, sd, ours: str, bidirectional: bool, num_layers: int) -> None:
    for layer in range(num_layers):
        for suffix in ("", "_reverse")[:2 if bidirectional else 1]:
            for kind in ("weight_ih", "weight_hh", "bias_ih", "bias_hh"):
                key = f"{kind}_l{layer}{suffix}"
                v = sd[f"rnn.{key}"]
                out[f"{ours}.{key}"] = np.transpose(v) if kind.startswith("weight") else v


def _port_mixer(out, sd, ours: str, theirs: str) -> None:
    for name in ("A_log", "D"):
        out[f"{ours}.{name}"] = sd[f"{theirs}.{name}"]
    _copy(out, sd, f"{ours}.conv", f"{theirs}.conv1d")
    for lin in ("in_proj", "dt_proj", "out_proj"):
        _copy(out, sd, f"{ours}.{lin}", f"{theirs}.{lin}")
    _copy(out, sd, f"{ours}.x_proj", f"{theirs}.x_proj", names=("weight",))


def _check(model: nn.Module, staged: Dict[str, np.ndarray], sd: _ConsumeTracker,
           skip: str) -> Dict[str, torch.Tensor]:
    """The consume-everything check, and every staged tensor against the
    model's tensors outside ``skip`` (the backbone, ported on its own):
    each present and of its shape. Returns the model's state_dict."""
    leftovers = sd.leftovers()
    if leftovers:
        raise ValueError(f"Unconsumed state_dict tensors (the config does not describe "
                         f"this checkpoint): {leftovers[:8]}...")
    target = model.state_dict()
    unported = sorted(k for k in target if k not in staged and not k.startswith(skip))
    if unported:
        raise KeyError(f"No state_dict tensor for the model's {unported[:8]}...")
    for name, value in staged.items():
        if name not in target:
            raise ValueError(f"the model has no tensor {name}")
        if tuple(np.shape(value)) != tuple(target[name].shape):
            raise ValueError(f"{name}: ported shape {tuple(np.shape(value))} != model "
                             f"{tuple(target[name].shape)}")
    return target


def port_reference_lrcn(model: nn.Module, state_dict, model_cfg) -> nn.Module:
    """Port a reference LRCN state_dict into the port's ``model`` in place
    (an ``LRCN`` built from ``model_cfg``, the ``ModelConfig`` that
    describes the checkpoint: backbone, rnn_type, sizes, classif_mode).
    Returns the model; raises ``KeyError`` / ``ValueError`` on mismatches."""
    sd = _ConsumeTracker(torch_tensor_dict(state_dict))
    # The rest is staged and checked first; the backbone porter then checks
    # and copies its part, and only after it the rest is copied.
    staged: Dict[str, np.ndarray] = {}
    for i in (1, 2, 3):
        _copy(staged, sd, f"adapt.adapt{i}", f"adapt{i}")
        _copy(staged, sd, f"adapt.bn{i}", f"bn{i}")
    if model_cfg.rnn_type == "mamba":
        for i in range(model_cfg.rnn_layer):
            staged[f"mamba_{i}.norm.weight"] = sd[f"rnn.{i}.norm.weight"]
            _port_mixer(staged, sd, f"mamba_{i}.mixer", f"rnn.{i}.mixer")
    else:
        _port_rnn(staged, sd, f"rnn.{model_cfg.rnn_type}", model_cfg.bidirectional,
                  model_cfg.rnn_layer)
    if model_cfg.classif_mode == "multiclass":
        for name in ("bn0", "fc", "bna", "fca", "bnb", "fcb"):
            _copy(staged, sd, f"head.{name}", name)
    else:
        # ModuleList of per-class Linear(F, 1) -> one Linear(F, C)
        n = model_cfg.num_classes
        staged["head.binary_heads.weight"] = np.concatenate(
            [sd[f"fc.{i}.weight"] for i in range(n)])
        staged["head.binary_heads.bias"] = np.concatenate([sd[f"fc.{i}.bias"] for i in range(n)])
    backbone_sd = sd.consume_region("cnn_backbone")
    target = _check(model, staged, sd, skip="cnn_backbone.")
    load_torch_backbone(model_cfg.cnn_backbone, model.cnn_backbone, backbone_sd)
    with torch.no_grad():
        for name, value in staged.items():
            target[name].copy_(torch.from_numpy(np.array(value)).to(target[name].dtype))
    return model


def port_reference_videomamba(model, state_dict, model_cfg):
    raise NotImplementedError("porting a reference VideoMamba is not in vct_torch yet "
                              "(ROADMAP Queue 1 item 5, with the VideoMamba model)")


def port_reference_s2vt(model, state_dict):
    raise NotImplementedError("porting a reference S2VT captioner is not in vct_torch yet "
                              "(ROADMAP Queue 1 item 6, with captioning)")
