"""VGG-16 and AlexNet backbones (feature extractors).

Port of ``vct/models/backbones/vgg.py``, the structure of
``torchvision.models.vgg16`` / ``alexnet``: conv (with bias) + ReLU stacks,
max pools, torchvision's adaptive average pool to 7x7 (VGG, 25088-d
output) or 6x6 (AlexNet, 9216-d), flattened. ``vct`` flattens its NHWC map,
so the features come in (h, w, c) order here too, and ``vct``'s weights for
the layer after it apply unchanged. The adaptive pool is
``F.adaptive_avg_pool2d``, whose windows are ``vct``'s general branch
(``vgg.py:79-101``): rows floor(i h / 7) to ceil((i + 1) h / 7), so at 80x80
(VGG's map 2x2) windows overlap and repeat. Submodule names are the Flax
ones (``conv{i}``).
"""

from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from vct_torch.models.backbones.common import Backbone

__all__ = ["VGG16", "vgg16", "AlexNet", "alexnet"]

_VGG16_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M", 512, 512, 512,
              "M"]


def _flatten_hwc(x):
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


class VGG16(Backbone):
    """VGG-16 features + 7x7 adaptive pool, flattened: output 25088."""

    feature_dim = 512 * 7 * 7

    def __init__(self):
        super().__init__()
        self.layers = []
        cin = 3
        for v in _VGG16_CFG:
            if v == "M":
                self.layers.append("M")
            else:
                name = f"conv{sum(l != 'M' for l in self.layers)}"
                self.add_module(name, nn.Conv2d(cin, v, 3, padding=1))
                self.layers.append(name)
                cin = v

    def forward(self, x):
        for name in self.layers:
            x = F.max_pool2d(x, 2, stride=2) if name == "M" else F.relu(getattr(self, name)(x))
        return _flatten_hwc(F.adaptive_avg_pool2d(x, 7))


class AlexNet(Backbone):
    """AlexNet features + 6x6 adaptive pool, flattened: output 9216."""

    feature_dim = 256 * 6 * 6

    def __init__(self):
        super().__init__()
        self.conv0 = nn.Conv2d(3, 64, 11, stride=4, padding=2)
        self.conv1 = nn.Conv2d(64, 192, 5, padding=2)
        self.conv2 = nn.Conv2d(192, 384, 3, padding=1)
        self.conv3 = nn.Conv2d(384, 256, 3, padding=1)
        self.conv4 = nn.Conv2d(256, 256, 3, padding=1)

    def forward(self, x):
        x = F.max_pool2d(F.relu(self.conv0(x)), 3, stride=2)
        x = F.max_pool2d(F.relu(self.conv1(x)), 3, stride=2)
        x = F.relu(self.conv2(x))
        x = F.relu(self.conv3(x))
        x = F.max_pool2d(F.relu(self.conv4(x)), 3, stride=2)
        return _flatten_hwc(F.adaptive_avg_pool2d(x, 6))


def vgg16() -> VGG16:
    return VGG16()


def alexnet() -> AlexNet:
    return AlexNet()
