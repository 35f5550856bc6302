"""Inception-V3 backbone (feature extractor, 2048-d output).

Port of ``vct/models/backbones/inception.py``, the structure of
``torchvision.models.inception_v3`` without the aux classifier: BasicConv2d
= conv + BatchNorm (eps 1e-3, ``vct``'s ``inception.py:35``, at its running
statistics) + ReLU; Mixed 5/6/7 blocks; a global average pool tail. Any
input of 75 px or more. The 3x3 average pools count their zero padding
(torch's ``count_include_pad=True``, as Flax's ``avg_pool``). Submodule
names are the Flax ones, which are torchvision's (``Conv2d_1a_3x3``,
``Mixed_5b.branch1x1``, ...).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from vct_torch.models.backbones.common import Backbone

__all__ = ["InceptionV3", "inception_v3"]


class _BasicConv(nn.Module):
    def __init__(self, cin: int, cout: int, kernel, stride: int = 1,
                 padding: Tuple[int, int] = (0, 0)):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride=stride, padding=padding, bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=1e-3)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


def _avg3(x):
    return F.avg_pool2d(x, 3, stride=1, padding=1)


def _max3s2(x):
    return F.max_pool2d(x, 3, stride=2)


class _InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int):
        super().__init__()
        self.branch1x1 = _BasicConv(cin, 64, 1)
        self.branch5x5_1 = _BasicConv(cin, 48, 1)
        self.branch5x5_2 = _BasicConv(48, 64, 5, padding=(2, 2))
        self.branch3x3dbl_1 = _BasicConv(cin, 64, 1)
        self.branch3x3dbl_2 = _BasicConv(64, 96, 3, padding=(1, 1))
        self.branch3x3dbl_3 = _BasicConv(96, 96, 3, padding=(1, 1))
        self.branch_pool = _BasicConv(cin, pool_features, 1)

    def forward(self, x):
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch1x1(x), b5, b3, self.branch_pool(_avg3(x))], dim=1)


class _InceptionB(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3 = _BasicConv(cin, 384, 3, stride=2)
        self.branch3x3dbl_1 = _BasicConv(cin, 64, 1)
        self.branch3x3dbl_2 = _BasicConv(64, 96, 3, padding=(1, 1))
        self.branch3x3dbl_3 = _BasicConv(96, 96, 3, stride=2)

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, _max3s2(x)], dim=1)


class _InceptionC(nn.Module):
    def __init__(self, cin: int, c7: int):
        super().__init__()
        self.branch1x1 = _BasicConv(cin, 192, 1)
        self.branch7x7_1 = _BasicConv(cin, c7, 1)
        self.branch7x7_2 = _BasicConv(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = _BasicConv(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = _BasicConv(cin, c7, 1)
        self.branch7x7dbl_2 = _BasicConv(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = _BasicConv(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = _BasicConv(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = _BasicConv(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = _BasicConv(cin, 192, 1)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_1(x)
        for i in range(2, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        return torch.cat([self.branch1x1(x), b7, bd, self.branch_pool(_avg3(x))], dim=1)


class _InceptionD(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3_1 = _BasicConv(cin, 192, 1)
        self.branch3x3_2 = _BasicConv(192, 320, 3, stride=2)
        self.branch7x7x3_1 = _BasicConv(cin, 192, 1)
        self.branch7x7x3_2 = _BasicConv(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = _BasicConv(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = _BasicConv(192, 192, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = self.branch7x7x3_1(x)
        for i in range(2, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return torch.cat([b3, b7, _max3s2(x)], dim=1)


class _InceptionE(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch1x1 = _BasicConv(cin, 320, 1)
        self.branch3x3_1 = _BasicConv(cin, 384, 1)
        self.branch3x3_2a = _BasicConv(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = _BasicConv(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = _BasicConv(cin, 448, 1)
        self.branch3x3dbl_2 = _BasicConv(448, 384, 3, padding=(1, 1))
        self.branch3x3dbl_3a = _BasicConv(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = _BasicConv(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = _BasicConv(cin, 192, 1)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], dim=1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], dim=1)
        return torch.cat([self.branch1x1(x), b3, bd, self.branch_pool(_avg3(x))], dim=1)


class InceptionV3(Backbone):
    feature_dim = 2048

    def __init__(self):
        super().__init__()
        self.Conv2d_1a_3x3 = _BasicConv(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = _BasicConv(32, 32, 3)
        self.Conv2d_2b_3x3 = _BasicConv(32, 64, 3, padding=(1, 1))
        self.Conv2d_3b_1x1 = _BasicConv(64, 80, 1)
        self.Conv2d_4a_3x3 = _BasicConv(80, 192, 3)
        self.Mixed_5b = _InceptionA(192, 32)
        self.Mixed_5c = _InceptionA(256, 64)
        self.Mixed_5d = _InceptionA(288, 64)
        self.Mixed_6a = _InceptionB(288)
        self.Mixed_6b = _InceptionC(768, 128)
        self.Mixed_6c = _InceptionC(768, 160)
        self.Mixed_6d = _InceptionC(768, 160)
        self.Mixed_6e = _InceptionC(768, 192)
        self.Mixed_7a = _InceptionD(768)
        self.Mixed_7b = _InceptionE(1280)
        self.Mixed_7c = _InceptionE(2048)

    def forward(self, x):
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(_max3s2(x)))
        x = _max3s2(x)
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a", "Mixed_6b", "Mixed_6c",
                     "Mixed_6d", "Mixed_6e", "Mixed_7a", "Mixed_7b", "Mixed_7c"):
            x = getattr(self, name)(x)
        return x.mean(dim=(2, 3))


def inception_v3() -> InceptionV3:
    return InceptionV3()
