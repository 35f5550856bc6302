"""ResNet backbone family (18/34/50/101/152), feature extractor.

Port of ``vct/models/backbones/resnet.py``: 7x7 stem, BasicBlock/Bottleneck
stages, global average pool, feature output (no fc). BatchNorm always runs in
inference mode with its running statistics, under ``train()`` too
(``common.Backbone``). Submodule names are the Flax ones
(``layer1_0.conv1``, ``downsample_conv``, ``downsample_bn``) so
``vct_torch.bridge`` maps weights mechanically.

Input is NCHW, in ``torch.channels_last`` memory format for the card (the
LRCN hands the (N, H, W, 3) frames over as a permuted view, which already
has that layout).
"""

from __future__ import annotations

from typing import Sequence, Type

import torch.nn.functional as F
from torch import nn

from vct_torch.models.backbones.common import Backbone

__all__ = ["ResNet", "resnet18", "resnet34", "resnet50", "resnet101", "resnet152"]


def _conv(cin: int, cout: int, kernel: int, stride: int, pad: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, kernel, stride=stride, padding=pad, bias=False)


class _BN(nn.BatchNorm2d):
    """``vct``'s ``_BN``: a Flax module that wraps its BatchNorm, whose
    variables therefore sit one level down, under ``BatchNorm_0``
    (``vct/models/backbones/resnet.py:57``); ``vct_torch.bridge`` reads
    ``flax_child``."""

    flax_child = "BatchNorm_0"


def _bn(c: int) -> nn.BatchNorm2d:
    return _BN(c, eps=1e-5)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin: int, features: int, stride: int = 1, downsample: bool = False):
        super().__init__()
        self.conv1 = _conv(cin, features, 3, stride, 1)
        self.bn1 = _bn(features)
        self.conv2 = _conv(features, features, 3, 1, 1)
        self.bn2 = _bn(features)
        if downsample:
            self.downsample_conv = _conv(cin, features, 1, stride, 0)
            self.downsample_bn = _bn(features)
        self.downsample = downsample

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        identity = self.downsample_bn(self.downsample_conv(x)) if self.downsample else x
        return F.relu(out + identity)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin: int, features: int, stride: int = 1, downsample: bool = False):
        super().__init__()
        out = features * 4
        self.conv1 = _conv(cin, features, 1, 1, 0)
        self.bn1 = _bn(features)
        self.conv2 = _conv(features, features, 3, stride, 1)
        self.bn2 = _bn(features)
        self.conv3 = _conv(features, out, 1, 1, 0)
        self.bn3 = _bn(out)
        if downsample:
            self.downsample_conv = _conv(cin, out, 1, stride, 0)
            self.downsample_bn = _bn(out)
        self.downsample = downsample

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = self.downsample_bn(self.downsample_conv(x)) if self.downsample else x
        return F.relu(out + identity)


class ResNet(Backbone):
    """Feature-extractor ResNet: input (N, 3, H, W) -> features (N, C)."""

    def __init__(self, block: Type[nn.Module], stage_sizes: Sequence[int]):
        super().__init__()
        self.conv1 = _conv(3, 64, 7, 2, 3)
        self.bn1 = _bn(64)
        self.blocks: list[str] = []
        in_features = 64
        for stage, (width, n_blocks) in enumerate(zip((64, 128, 256, 512), stage_sizes)):
            for i in range(n_blocks):
                stride = 2 if (stage > 0 and i == 0) else 1
                needs_ds = stride != 1 or in_features != width * block.expansion
                name = f"layer{stage + 1}_{i}"
                self.add_module(name, block(in_features, width, stride, needs_ds))
                self.blocks.append(name)
                in_features = width * block.expansion
        self.feature_dim = 512 * block.expansion

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        for name in self.blocks:
            x = getattr(self, name)(x)
        return x.mean(dim=(2, 3))


def resnet18() -> ResNet:
    return ResNet(BasicBlock, (2, 2, 2, 2))


def resnet34() -> ResNet:
    return ResNet(BasicBlock, (3, 4, 6, 3))


def resnet50() -> ResNet:
    return ResNet(Bottleneck, (3, 4, 6, 3))


def resnet101() -> ResNet:
    return ResNet(Bottleneck, (3, 4, 23, 3))


def resnet152() -> ResNet:
    return ResNet(Bottleneck, (3, 8, 36, 3))
