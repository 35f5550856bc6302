"""VideoMamba: frozen CNN + linear adapt + Mamba residual stack + pooling.

Port of ``vct/models/videomamba.py`` (the reference's ``lrcn/videomamba.py:
332-434``): one Linear projection of the backbone features to ``d_model``,
``n_layer`` selective-scan residual blocks (``MambaResidualBlock``, the
LRCN's, named ``layer_{i}``), a final RMSNorm ``norm_f``, temporal pooling
(mean | max | last | all) and one Linear ``classifier`` (the reference's
per-class binary heads fused into one, identical logits). The backbone runs
as the LRCN's does (``lrcn.backbone_features``): bf16 autocast with
``compute_dtype="bfloat16"``, f32 features, ``no_grad`` while frozen. With
``scan_impl="pallas"`` every block's scan is the card's K3 kernel, forward
and backward.
"""

from __future__ import annotations

import torch
from torch import nn

from vct_torch.core.config import ModelConfig
from vct_torch.models.backbones import build_backbone
from vct_torch.models.layers import RMSNorm
from vct_torch.models.lrcn import backbone_features
from vct_torch.models.ssm import MambaResidualBlock

__all__ = ["VideoMamba", "build_videomamba"]

TEMPORAL_MODES = ("mean", "max", "last", "all")


class VideoMamba(nn.Module):
    # Trainer's feature cache: features_only / from_features split the forward.
    supports_feature_cache = True

    def __init__(self, num_classes: int, cnn_backbone: str = "resnet50", n_layer: int = 4,
                 d_model: int = 512, d_inner: int = 2048, n_state: int = 16, dt_rank: int = 16,
                 num_frames: int = 16, temporal_mode: str = "mean",
                 scan_impl: str = "associative", dtype: torch.dtype = torch.float32):
        super().__init__()
        if temporal_mode not in TEMPORAL_MODES:
            raise ValueError(f"Unknown temporal mode: {temporal_mode}")
        self.temporal_mode = temporal_mode
        self.dtype = dtype
        self.cnn_backbone, feat = build_backbone(cnn_backbone)
        self.adapt = nn.Linear(feat, d_model)
        self.blocks = [f"layer_{i}" for i in range(n_layer)]
        for name in self.blocks:
            self.add_module(name, MambaResidualBlock(d_model, d_inner, n_state, dt_rank,
                                                     scan_impl=scan_impl))
        self.norm_f = RMSNorm(d_model)
        pooled = d_model * (num_frames if temporal_mode == "all" else 1)
        self.classifier = nn.Linear(pooled, num_classes)

    def temporal_pool(self, x):
        if self.temporal_mode == "mean":
            return x.mean(dim=1)
        if self.temporal_mode == "max":
            return x.amax(dim=1)
        if self.temporal_mode == "last":
            return x[:, -1]
        return x.reshape(x.shape[0], -1)

    def forward(self, x, *, from_features: bool = False, features_only: bool = False):
        feats = x if from_features else backbone_features(self.cnn_backbone, x, self.dtype)
        if features_only:
            return feats
        h = self.adapt(feats.to(torch.float32))
        for name in self.blocks:
            h = getattr(self, name)(h)
        return self.classifier(self.temporal_pool(self.norm_f(h)))


def build_videomamba(cfg: ModelConfig, sequence_length: int) -> VideoMamba:
    dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32
    return VideoMamba(
        num_classes=cfg.num_classes,
        cnn_backbone=cfg.cnn_backbone,
        n_layer=cfg.vm_n_layer,
        d_model=cfg.vm_d_model,
        d_inner=cfg.vm_d_inner,
        n_state=cfg.vm_n_state,
        dt_rank=cfg.vm_dt_rank,
        num_frames=sequence_length,
        temporal_mode=cfg.vm_temporal_mode,
        scan_impl=cfg.scan_impl,
        dtype=dtype,
    )
