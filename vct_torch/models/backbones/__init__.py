"""Backbone registry, string-keyed like the reference's dispatch
(``getattr(torchvision.models, name)``, ``models.py:133``): the eleven names
``vct/models/backbones/__init__.py`` registers. Another name raises
``KeyError`` listing them.
"""

from __future__ import annotations

from vct_torch.core.registry import Registry
from vct_torch.models.backbones.densenet import densenet121
from vct_torch.models.backbones.efficientnet import efficientnet_b0
from vct_torch.models.backbones.inception import inception_v3
from vct_torch.models.backbones.mobilenet import mobilenet_v2
from vct_torch.models.backbones.resnet import (
    resnet18,
    resnet34,
    resnet50,
    resnet101,
    resnet152,
)
from vct_torch.models.backbones.vgg import alexnet, vgg16

__all__ = ["BACKBONES", "build_backbone"]

BACKBONES = Registry("backbone")
for _name, _factory in [
    ("resnet18", resnet18),
    ("resnet34", resnet34),
    ("resnet50", resnet50),
    ("resnet101", resnet101),
    ("resnet152", resnet152),
    ("mobilenet_v2", mobilenet_v2),
    ("densenet121", densenet121),
    ("vgg16", vgg16),
    ("alexnet", alexnet),
    ("efficientnet_b0", efficientnet_b0),
    ("inception_v3", inception_v3),
]:
    BACKBONES.register(_name, _factory)


def build_backbone(name: str):
    """Instantiate a backbone module by name; returns (module, feature_dim)."""
    module = BACKBONES.get(name)()
    return module, module.feature_dim
