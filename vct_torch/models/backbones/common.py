"""What every backbone family shares: BatchNorm kept at its running
statistics in every mode, as ``vct`` keeps its ported backbones (frozen in
every reference configuration, ``models.py:144-145``)."""

from __future__ import annotations

from torch import nn

__all__ = ["Backbone"]


class Backbone(nn.Module):
    """A feature extractor, input (N, 3, H, W) -> features (N, ``feature_dim``).
    ``train()`` sets the mode but keeps every BatchNorm in eval mode: its
    running statistics, never batch statistics or running-stat updates."""

    feature_dim: int

    def train(self, mode: bool = True):
        super().train(mode)
        for m in self.modules():
            if isinstance(m, nn.BatchNorm2d):
                m.eval()
        return self
