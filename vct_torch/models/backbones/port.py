"""torchvision state_dicts into the port's backbones: the port of
``vct/models/backbones/port.py``.

The reference builds every backbone with torchvision's ImageNet weights
(``medsos_lrcn/src/models.py:133`` ``pretrained=True``). Nothing here
downloads: a user supplies a torchvision ``state_dict`` (``.pth`` of tensors,
or ``.npz``) and these routines map it onto the port's modules, whose names
are the Flax ones:

  * ResNet: ``layer1.0.conv1`` -> ``layer1_0.conv1``; ``layer2.0.downsample.0``
    / ``.1`` -> ``layer2_0.downsample_conv`` / ``downsample_bn``;
  * MobileNetV2: ``features.{b+1}.conv.{j}.0`` / ``.1`` ->
    ``block{b}.conv{j}.conv`` / ``.bn``, the projection a bare
    ``features.{b+1}.conv.{n-1}`` + ``.{n}`` pair; ``features.0`` / ``18``
    -> ``stem`` / ``head``;
  * DenseNet-121: ``features.denseblock{i+1}.denselayer{j+1}`` ->
    ``block{i}_layer{j}``, ``features.transition{i+1}`` -> ``transition{i}``;
  * VGG-16, AlexNet: the convs (with bias) of ``features.{idx}`` ->
    ``conv{i}`` in order;
  * EfficientNet-B0: ``features.{s+1}.{j}.block.{k}`` -> ``block{b}`` (the
    blocks numbered across stages), its squeeze-excite ``.fc1`` / ``.fc2``
    (with bias) -> ``se.fc1`` / ``se.fc2``; ``features.0`` / ``8`` ->
    ``stem`` / ``head``;
  * Inception-V3: the names are torchvision's (``Mixed_5b.branch1x1.conv``);
  * conv weights are OIHW on both sides (depthwise ones (C, 1, k, k)), so
    nothing is transposed; BatchNorm ``weight``, ``bias``, ``running_mean``,
    ``running_var`` keep their names (the backbones always run BN on its
    running statistics); ``num_batches_tracked`` is read and not used;
  * the classifier (``fc.*``, ``classifier.*``, Inception's ``AuxLogits.*``)
    is dropped (the reference replaces it with ``nn.Identity``,
    ``models.py:134-141``).

Strict, like ``vct``'s: a tensor the backbone needs and the state_dict
lacks raises ``KeyError``; an unconsumed tensor or a shape mismatch raises
``ValueError``; nothing is written unless every tensor maps. A name with no
porter raises ``KeyError``.

``fold_input_scale_into_stem`` folds the input's 1/255 into a backbone's
stem conv, so raw uint8 frames cast to the compute dtype go straight in.
"""

from __future__ import annotations

import copy
import re
from typing import Dict

import numpy as np
import torch
from torch import nn

__all__ = [
    "PORTERS",
    "fold_input_scale_into_stem",
    "load_state_dict_file",
    "load_torch_alexnet",
    "load_torch_backbone",
    "load_torch_densenet121",
    "load_torch_efficientnet_b0",
    "load_torch_inception_v3",
    "load_torch_mobilenet_v2",
    "load_torch_resnet",
    "load_torch_vgg16",
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

    def conv(self, ours: str, theirs: str, bias: bool = False) -> None:
        self.put(f"{ours}.weight", f"{theirs}.weight")
        if bias:
            self.put(f"{ours}.bias", f"{theirs}.bias")

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


def load_torch_mobilenet_v2(backbone: nn.Module, state_dict) -> nn.Module:
    """torchvision's mobilenet_v2 into the port's ``MobileNetV2`` in place."""
    p = _Porter(backbone, state_dict, drop=("classifier.",))
    p.conv("stem.conv", "features.0.0")
    p.bn("stem.bn", "features.0.1")
    for b, ours in enumerate(backbone.blocks):
        theirs, n = f"features.{b + 1}.conv", getattr(backbone, ours).n_convs
        # (expand,) depthwise: Conv2dNormActivation pairs; the projection a
        # bare Conv2d at index n-1 and its BatchNorm2d at n.
        for j in range(n - 1):
            p.conv(f"{ours}.conv{j}.conv", f"{theirs}.{j}.0")
            p.bn(f"{ours}.conv{j}.bn", f"{theirs}.{j}.1")
        p.conv(f"{ours}.conv{n - 1}.conv", f"{theirs}.{n - 1}")
        p.bn(f"{ours}.conv{n - 1}.bn", f"{theirs}.{n}")
    p.conv("head.conv", "features.18.0")
    p.bn("head.bn", "features.18.1")
    return p.finish()


def load_torch_densenet121(backbone: nn.Module, state_dict) -> nn.Module:
    """torchvision's densenet121 into the port's ``DenseNet`` in place."""
    p = _Porter(backbone, state_dict, drop=("classifier.",))
    p.conv("conv0", "features.conv0")
    p.bn("norm0", "features.norm0")
    for ours in backbone.stages:
        if ours.startswith("transition"):
            theirs = f"features.transition{int(ours[len('transition'):]) + 1}"
            p.bn(f"{ours}.norm", f"{theirs}.norm")
            p.conv(f"{ours}.conv", f"{theirs}.conv")
            continue
        block, layer = (int(v) for v in re.fullmatch(r"block(\d+)_layer(\d+)", ours).groups())
        theirs = f"features.denseblock{block + 1}.denselayer{layer + 1}"
        for name in ("norm1", "conv1", "norm2", "conv2"):
            (p.bn if name.startswith("norm") else p.conv)(f"{ours}.{name}", f"{theirs}.{name}")
    p.bn("norm5", "features.norm5")
    return p.finish()


# torchvision's features.{idx} of each conv, in order.
_VGG16_FEATURE_IDX = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)
_ALEXNET_FEATURE_IDX = (0, 3, 6, 8, 10)


def _plain_convs(backbone: nn.Module, state_dict, feature_idx) -> nn.Module:
    p = _Porter(backbone, state_dict, drop=("classifier.",))
    for i, idx in enumerate(feature_idx):
        p.conv(f"conv{i}", f"features.{idx}", bias=True)
    return p.finish()


def load_torch_vgg16(backbone: nn.Module, state_dict) -> nn.Module:
    """torchvision's vgg16 into the port's ``VGG16`` in place."""
    return _plain_convs(backbone, state_dict, _VGG16_FEATURE_IDX)


def load_torch_alexnet(backbone: nn.Module, state_dict) -> nn.Module:
    """torchvision's alexnet into the port's ``AlexNet`` in place."""
    return _plain_convs(backbone, state_dict, _ALEXNET_FEATURE_IDX)


# Blocks a stage of torchvision's efficientnet_b0; the port numbers them across stages.
_EFFB0_REPEATS = (1, 2, 2, 3, 3, 4, 1)


def load_torch_efficientnet_b0(backbone: nn.Module, state_dict) -> nn.Module:
    """torchvision's efficientnet_b0 into the port's ``EfficientNetB0`` in place."""
    p = _Porter(backbone, state_dict, drop=("classifier.",))
    p.conv("stem.conv", "features.0.0")
    p.bn("stem.bn", "features.0.1")
    stages = [(s, j) for s, n in enumerate(_EFFB0_REPEATS) for j in range(n)]
    if len(stages) != len(backbone.blocks):
        raise ValueError(f"efficientnet_b0 has {len(stages)} blocks, the backbone "
                         f"{len(backbone.blocks)}")
    for ours, (stage, j) in zip(backbone.blocks, stages):
        theirs, n = f"features.{stage + 1}.{j}.block", getattr(backbone, ours).n_convs
        # (expand,) depthwise, squeeze-excite at index n-1, projection at n.
        for k in range(n - 1):
            p.conv(f"{ours}.conv{k}.conv", f"{theirs}.{k}.0")
            p.bn(f"{ours}.conv{k}.bn", f"{theirs}.{k}.1")
        p.conv(f"{ours}.se.fc1", f"{theirs}.{n - 1}.fc1", bias=True)
        p.conv(f"{ours}.se.fc2", f"{theirs}.{n - 1}.fc2", bias=True)
        p.conv(f"{ours}.conv{n - 1}.conv", f"{theirs}.{n}.0")
        p.bn(f"{ours}.conv{n - 1}.bn", f"{theirs}.{n}.1")
    p.conv("head.conv", "features.8.0")
    p.bn("head.bn", "features.8.1")
    return p.finish()


def load_torch_inception_v3(backbone: nn.Module, state_dict) -> nn.Module:
    """torchvision's inception_v3 into the port's ``InceptionV3`` in place
    (the aux classifier dropped). The port's names are torchvision's: each
    BasicConv2d's ``conv`` and ``bn``."""
    p = _Porter(backbone, state_dict, drop=("fc.", "AuxLogits."))
    for name, mod in backbone.named_modules():
        if isinstance(getattr(mod, "conv", None), nn.Conv2d):
            p.conv(f"{name}.conv", f"{name}.conv")
            p.bn(f"{name}.bn", f"{name}.bn")
    return p.finish()


PORTERS = {
    **{name: load_torch_resnet
       for name in ("resnet18", "resnet34", "resnet50", "resnet101", "resnet152")},
    "mobilenet_v2": load_torch_mobilenet_v2,
    "densenet121": load_torch_densenet121,
    "vgg16": load_torch_vgg16,
    "alexnet": load_torch_alexnet,
    "efficientnet_b0": load_torch_efficientnet_b0,
    "inception_v3": load_torch_inception_v3,
}


def load_torch_backbone(name: str, backbone: nn.Module, state_dict) -> nn.Module:
    """Port a torchvision ``state_dict`` for backbone ``name`` into
    ``backbone`` in place. Raises on an unknown name, missing tensors,
    extra tensors, or any shape mismatch."""
    if name not in PORTERS:
        raise KeyError(f"No weight porter for backbone {name!r}; available: {sorted(PORTERS)}")
    return PORTERS[name](backbone, state_dict)


# Stem conv module path per family, for input-scale folding.
_STEM_KERNEL_PATH = {
    "resnet18": ("conv1",), "resnet34": ("conv1",), "resnet50": ("conv1",),
    "resnet101": ("conv1",), "resnet152": ("conv1",),
    "mobilenet_v2": ("stem", "conv"),
    "efficientnet_b0": ("stem", "conv"),
    "densenet121": ("conv0",),
    "vgg16": ("conv0",), "alexnet": ("conv0",),
    "inception_v3": ("Conv2d_1a_3x3", "conv"),
}


def fold_input_scale_into_stem(backbone: nn.Module, backbone_name: str,
                               scale: float = 1.0 / 255.0) -> nn.Module:
    """A copy of ``backbone`` with the input normalization folded into its
    stem conv: conv(x * s, w) == conv(x, w * s), and a stem bias adds after
    the contraction, so it stays as it is. Raw uint8 frames, cast to the
    compute dtype (0-255 is exact in bf16), then go straight into the conv
    stack in place of x / 255. ``backbone`` is left unchanged."""
    if backbone_name not in _STEM_KERNEL_PATH:
        raise KeyError(
            f"No stem path for backbone {backbone_name!r}; "
            f"available: {sorted(_STEM_KERNEL_PATH)}"
        )
    out = copy.deepcopy(backbone)
    conv = out
    for key in _STEM_KERNEL_PATH[backbone_name]:
        conv = getattr(conv, key)
    with torch.no_grad():
        conv.weight.mul_(scale)
    return out


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
