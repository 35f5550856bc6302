"""torchvision state_dicts into the port's backbones: the port of
``vct/models/backbones/port.py``.

The reference builds every backbone with torchvision's ImageNet weights
(``medsos_lrcn/src/models.py:133`` ``pretrained=True``). Nothing here
downloads: a user supplies a torchvision ``state_dict`` (``.pth`` of tensors,
or ``.npz``) and these routines map it onto the port's modules, whose names
are the Flax ones:

  * ``layer1.0.conv1`` -> ``layer1_0.conv1``; ``layer2.0.downsample.0`` /
    ``.1`` -> ``layer2_0.downsample_conv`` / ``downsample_bn``;
  * conv weights are OIHW on both sides, so nothing is transposed;
  * BatchNorm ``weight``, ``bias``, ``running_mean``, ``running_var`` keep
    their names (the backbones always run BN on its running statistics);
    ``num_batches_tracked`` is read and not used;
  * the classifier ``fc.*`` is dropped (the reference replaces it with
    ``nn.Identity``, ``models.py:134-136``).

Strict, like ``vct``'s: a tensor the backbone needs and the state_dict
lacks raises ``KeyError``; an unconsumed tensor or a shape mismatch raises
``ValueError``; nothing is written unless every tensor maps. Only the
ResNet family is ported so far; another name raises ``NotImplementedError``
(ROADMAP Queue 1 item 5, which brings the other backbones).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

__all__ = [
    "PORTERS",
    "load_state_dict_file",
    "load_torch_backbone",
    "load_torch_resnet",
    "port_backbone_into_model",
    "torch_tensor_dict",
]


def torch_tensor_dict(state_dict) -> Dict[str, np.ndarray]:
    """Accept a torch state_dict (tensors) or a dict of arrays."""
    out = {}
    for key, value in state_dict.items():
        if hasattr(value, "detach"):
            value = value.detach().cpu().numpy()
        out[key] = np.asarray(value)
    return out


class _Porter:
    """Strict consume-everything mapper from a torchvision state_dict onto
    ``module``'s tensors. ``drop`` prefixes (the classifier head) are
    ignored without being required."""

    def __init__(self, module: nn.Module, state_dict, drop=()):
        self.module = module
        self.sd = torch_tensor_dict(state_dict)
        self.drop = tuple(drop)
        self.target = module.state_dict()
        self.consumed = set()
        self.staged: Dict[str, np.ndarray] = {}

    def take(self, key: str) -> np.ndarray:
        if key not in self.sd:
            raise KeyError(f"Missing tensor in state_dict: {key}")
        self.consumed.add(key)
        return self.sd[key]

    def put(self, ours: str, theirs: str) -> None:
        value = self.take(theirs)
        want = tuple(self.target[ours].shape)
        if tuple(value.shape) != want:
            raise ValueError(f"{theirs}: shape {tuple(value.shape)} != expected {want}")
        self.staged[ours] = value

    def conv(self, ours: str, theirs: str) -> None:
        self.put(f"{ours}.weight", f"{theirs}.weight")

    def bn(self, ours: str, theirs: str) -> None:
        for name in ("weight", "bias", "running_mean", "running_var"):
            self.put(f"{ours}.{name}", f"{theirs}.{name}")
        self.consumed.add(f"{theirs}.num_batches_tracked")

    @torch.no_grad()
    def finish(self) -> nn.Module:
        leftovers = sorted(
            k for k in self.sd
            if k not in self.consumed and not k.endswith("num_batches_tracked")
            and not k.startswith(self.drop)
        )
        if leftovers:
            raise ValueError(f"Unconsumed state_dict tensors: {leftovers[:8]}...")
        unported = sorted(k for k in self.target
                          if k not in self.staged and not k.endswith("num_batches_tracked"))
        if unported:
            raise KeyError(f"No state_dict tensor for {unported[:8]}...")
        for name, value in self.staged.items():
            dst = self.target[name]
            dst.copy_(torch.from_numpy(np.array(value)).to(dst.dtype))
        return self.module


def load_torch_resnet(backbone: nn.Module, state_dict) -> nn.Module:
    """Port a torchvision ResNet state_dict into the port's ``ResNet``
    ``backbone`` in place (``fc.*`` ignored); returns the backbone."""
    p = _Porter(backbone, state_dict, drop=("fc.",))
    p.conv("conv1", "conv1")
    p.bn("bn1", "bn1")
    for stage in range(1, 5):
        block = 0
        while hasattr(backbone, f"layer{stage}_{block}"):
            ours, theirs = f"layer{stage}_{block}", f"layer{stage}.{block}"
            mod = getattr(backbone, ours)
            ci = 1
            while hasattr(mod, f"conv{ci}"):
                p.conv(f"{ours}.conv{ci}", f"{theirs}.conv{ci}")
                p.bn(f"{ours}.bn{ci}", f"{theirs}.bn{ci}")
                ci += 1
            if mod.downsample:
                p.conv(f"{ours}.downsample_conv", f"{theirs}.downsample.0")
                p.bn(f"{ours}.downsample_bn", f"{theirs}.downsample.1")
            block += 1
    return p.finish()


PORTERS = {name: load_torch_resnet
           for name in ("resnet18", "resnet34", "resnet50", "resnet101", "resnet152")}


def load_torch_backbone(name: str, backbone: nn.Module, state_dict) -> nn.Module:
    """Port a torchvision ``state_dict`` for backbone ``name`` into
    ``backbone`` in place. Raises on an unported family, missing tensors,
    extra tensors, or any shape mismatch."""
    if name not in PORTERS:
        raise NotImplementedError(
            f"No weight porter for backbone {name!r} in vct_torch yet (ROADMAP Queue 1 item 5); "
            f"available: {sorted(PORTERS)}"
        )
    return PORTERS[name](backbone, state_dict)


def load_state_dict_file(path: str) -> Dict[str, np.ndarray]:
    """Read a state_dict from disk: ``.npz`` (numpy) or torch ``.pth``
    (tensors only: ``torch.load(weights_only=True)``)."""
    if path.endswith(".npz"):
        with np.load(path) as z:
            return {k: z[k] for k in z.files}
    return torch_tensor_dict(torch.load(path, map_location="cpu", weights_only=True))


def port_backbone_into_model(model: nn.Module, backbone_name: str, state_dict,
                             module_name: str = "cnn_backbone") -> nn.Module:
    """Port torchvision backbone weights into the submodule ``module_name``
    of a whole model in place (the LRCN's ``cnn_backbone``); every other
    tensor of the model is left as it was. Returns the model."""
    backbone = getattr(model, module_name, None)
    if not isinstance(backbone, nn.Module):
        raise KeyError(f"The model has no {module_name!r} submodule")
    load_torch_backbone(backbone_name, backbone, state_dict)
    return model
