"""MobileNetV2 backbone (feature extractor, 1280-d output).

Port of ``vct/models/backbones/mobilenet.py``, the structure of
``torchvision.models.mobilenet_v2``: inverted residual blocks with ReLU6 and
depthwise 3x3 convs, BatchNorm (eps 1e-5) at its running statistics, a
global average pool tail. The backbone of the reference's best Bayesian-sweep
config (mamba + mobilenet_v2). Submodule names are the Flax ones
(``stem``, ``block{i}.conv{j}``, ``head``, each a ``conv`` + ``bn`` pair).
"""

from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from vct_torch.models.backbones.common import Backbone

__all__ = ["MobileNetV2", "mobilenet_v2"]


def _round8(v: float) -> int:
    new_v = max(8, int(v + 4) // 8 * 8)
    if new_v < 0.9 * v:
        new_v += 8
    return new_v


class _ConvBNReLU(nn.Module):
    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1, groups: int = 1,
                 act: bool = True):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride=stride, padding=(kernel - 1) // 2,
                              groups=groups, bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=1e-5)
        self.act = act

    def forward(self, x):
        x = self.bn(self.conv(x))
        return F.relu6(x) if self.act else x


class _InvertedResidual(nn.Module):
    def __init__(self, cin: int, features: int, stride: int, expand_ratio: int):
        super().__init__()
        hidden = int(round(cin * expand_ratio))
        self.use_res = stride == 1 and cin == features
        convs = [_ConvBNReLU(cin, hidden, 1, 1)] if expand_ratio != 1 else []
        convs += [_ConvBNReLU(hidden, hidden, 3, stride, groups=hidden),
                  _ConvBNReLU(hidden, features, 1, 1, act=False)]
        self.n_convs = len(convs)
        for i, conv in enumerate(convs):
            self.add_module(f"conv{i}", conv)

    def forward(self, x):
        out = x
        for i in range(self.n_convs):
            out = getattr(self, f"conv{i}")(out)
        return x + out if self.use_res else out


# (expand_ratio, channels, num_blocks, first_stride): torchvision's defaults.
_CFG = [
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
]


class MobileNetV2(Backbone):
    feature_dim = 1280

    def __init__(self):
        super().__init__()
        cin = _round8(32)
        self.stem = _ConvBNReLU(3, cin, 3, 2)
        self.blocks = []
        for t, c, n, s in _CFG:
            for i in range(n):
                name = f"block{len(self.blocks)}"
                self.add_module(name, _InvertedResidual(cin, _round8(c), s if i == 0 else 1, t))
                self.blocks.append(name)
                cin = _round8(c)
        self.head = _ConvBNReLU(cin, 1280, 1, 1)

    def forward(self, x):
        x = self.stem(x)
        for name in self.blocks:
            x = getattr(self, name)(x)
        return self.head(x).mean(dim=(2, 3))


def mobilenet_v2() -> MobileNetV2:
    return MobileNetV2()
