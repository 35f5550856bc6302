"""EfficientNet-B0 backbone (feature extractor, 1280-d output).

Port of ``vct/models/backbones/efficientnet.py``, the structure of
``torchvision.models.efficientnet_b0``: MBConv blocks with squeeze-excite
(1x1 convs with bias, squeezed to a quarter of the block's input channels),
SiLU, BatchNorm at eps 1e-3 (torchvision's, ``vct``'s ``efficientnet.py:47``)
at its running statistics, a global average pool tail. Submodule names are
the Flax ones (``stem``, ``block{i}.conv{j}``, ``block{i}.se.fc1/fc2``,
``head``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from vct_torch.models.backbones.common import Backbone

__all__ = ["EfficientNetB0", "efficientnet_b0"]


def _round8(v: float) -> int:
    new_v = max(8, int(v + 4) // 8 * 8)
    if new_v < 0.9 * v:
        new_v += 8
    return new_v


class _ConvBNAct(nn.Module):
    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1, groups: int = 1,
                 act: bool = True):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride=stride, padding=(kernel - 1) // 2,
                              groups=groups, bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=1e-3)
        self.act = act

    def forward(self, x):
        x = self.bn(self.conv(x))
        return F.silu(x) if self.act else x


class _SqueezeExcite(nn.Module):
    def __init__(self, channels: int, squeeze: int):
        super().__init__()
        self.fc1 = nn.Conv2d(channels, squeeze, 1)
        self.fc2 = nn.Conv2d(squeeze, channels, 1)

    def forward(self, x):
        s = x.mean(dim=(2, 3), keepdim=True)
        return x * torch.sigmoid(self.fc2(F.silu(self.fc1(s))))


class _MBConv(nn.Module):
    def __init__(self, cin: int, features: int, kernel: int, stride: int, expand_ratio: int):
        super().__init__()
        hidden = cin * expand_ratio
        self.use_res = stride == 1 and cin == features
        convs = [_ConvBNAct(cin, hidden, 1, 1)] if expand_ratio != 1 else []
        convs.append(_ConvBNAct(hidden, hidden, kernel, stride, groups=hidden))
        for i, conv in enumerate(convs):
            self.add_module(f"conv{i}", conv)
        # The squeeze is a quarter of the block's input channels.
        self.se = _SqueezeExcite(hidden, max(1, cin // 4))
        self.n_convs = len(convs) + 1
        self.add_module(f"conv{len(convs)}", _ConvBNAct(hidden, features, 1, 1, act=False))

    def forward(self, x):
        out = x
        for i in range(self.n_convs - 1):
            out = getattr(self, f"conv{i}")(out)
        out = getattr(self, f"conv{self.n_convs - 1}")(self.se(out))
        return x + out if self.use_res else out


# (expand, kernel, stride, channels, repeats): torchvision's B0.
_CFG = [
    (1, 3, 1, 16, 1),
    (6, 3, 2, 24, 2),
    (6, 5, 2, 40, 2),
    (6, 3, 2, 80, 3),
    (6, 5, 1, 112, 3),
    (6, 5, 2, 192, 4),
    (6, 3, 1, 320, 1),
]


class EfficientNetB0(Backbone):
    feature_dim = 1280

    def __init__(self):
        super().__init__()
        cin = _round8(32)
        self.stem = _ConvBNAct(3, cin, 3, 2)
        self.blocks = []
        for t, k, s, c, n in _CFG:
            for i in range(n):
                name = f"block{len(self.blocks)}"
                self.add_module(name, _MBConv(cin, _round8(c), k, s if i == 0 else 1, t))
                self.blocks.append(name)
                cin = _round8(c)
        self.head = _ConvBNAct(cin, 1280, 1, 1)

    def forward(self, x):
        x = self.stem(x)
        for name in self.blocks:
            x = getattr(self, name)(x)
        return self.head(x).mean(dim=(2, 3))


def efficientnet_b0() -> EfficientNetB0:
    return EfficientNetB0()
