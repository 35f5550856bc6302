"""Backbone registry, string-keyed like the reference's dispatch.

Only the ResNet family is ported so far; any other name raises ``KeyError``
listing what is available (the rest of the zoo is ROADMAP Queue 1).
"""

from __future__ import annotations

from vct_torch.core.registry import Registry
from vct_torch.models.backbones.resnet import (
    resnet18,
    resnet34,
    resnet50,
    resnet101,
    resnet152,
)

__all__ = ["BACKBONES", "build_backbone"]

BACKBONES = Registry("backbone")
for _name, _factory in [
    ("resnet18", resnet18),
    ("resnet34", resnet34),
    ("resnet50", resnet50),
    ("resnet101", resnet101),
    ("resnet152", resnet152),
]:
    BACKBONES.register(_name, _factory)


def build_backbone(name: str):
    """Instantiate a backbone module by name; returns (module, feature_dim)."""
    module = BACKBONES.get(name)()
    return module, module.feature_dim
