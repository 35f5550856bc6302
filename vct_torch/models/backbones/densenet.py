"""DenseNet-121 backbone (feature extractor, 1024-d output).

Port of ``vct/models/backbones/densenet.py``, the structure of
``torchvision.models.densenet121``: BN -> ReLU -> conv dense layers whose
outputs concatenate onto their input's channels, transitions that halve the
channels and average-pool 2x2, a final BN -> ReLU -> global average pool.
BatchNorm (eps 1e-5) at its running statistics. Submodule names are the
Flax ones (``conv0``, ``norm0``, ``block{i}_layer{j}``, ``transition{i}``,
``norm5``).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from vct_torch.models.backbones.common import Backbone

__all__ = ["DenseNet", "densenet121"]


def _bn(c: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(c, eps=1e-5)


class _DenseLayer(nn.Module):
    def __init__(self, cin: int, growth_rate: int, bn_size: int = 4):
        super().__init__()
        self.norm1 = _bn(cin)
        self.conv1 = nn.Conv2d(cin, bn_size * growth_rate, 1, bias=False)
        self.norm2 = _bn(bn_size * growth_rate)
        self.conv2 = nn.Conv2d(bn_size * growth_rate, growth_rate, 3, padding=1, bias=False)

    def forward(self, x):
        out = self.conv1(F.relu(self.norm1(x)))
        out = self.conv2(F.relu(self.norm2(out)))
        return torch.cat([x, out], dim=1)


class _Transition(nn.Module):
    def __init__(self, cin: int, features: int):
        super().__init__()
        self.norm = _bn(cin)
        self.conv = nn.Conv2d(cin, features, 1, bias=False)

    def forward(self, x):
        return F.avg_pool2d(self.conv(F.relu(self.norm(x))), 2, stride=2)


class DenseNet(Backbone):
    def __init__(self, block_config: Sequence[int] = (6, 12, 24, 16), growth_rate: int = 32,
                 init_features: int = 64):
        super().__init__()
        self.conv0 = nn.Conv2d(3, init_features, 7, stride=2, padding=3, bias=False)
        self.norm0 = _bn(init_features)
        self.stages = []
        ch = init_features
        for i, n_layers in enumerate(block_config):
            for j in range(n_layers):
                self.add_module(f"block{i}_layer{j}", _DenseLayer(ch + j * growth_rate,
                                                                  growth_rate))
                self.stages.append(f"block{i}_layer{j}")
            ch += n_layers * growth_rate
            if i != len(block_config) - 1:
                self.add_module(f"transition{i}", _Transition(ch, ch // 2))
                self.stages.append(f"transition{i}")
                ch //= 2
        self.norm5 = _bn(ch)
        self.feature_dim = ch

    def forward(self, x):
        x = F.relu(self.norm0(self.conv0(x)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        for name in self.stages:
            x = getattr(self, name)(x)
        return F.relu(self.norm5(x)).mean(dim=(2, 3))


def densenet121() -> DenseNet:
    return DenseNet(block_config=(6, 12, 24, 16))
