"""LRCN — frozen CNN backbone + adapter MLP + {LSTM, GRU, Mamba} temporal head.

Port of ``vct/models/lrcn.py``:

    (B, T, H, W, 3) ──flatten B·T──► backbone ──► (B, T, F)
      ──► adapter (canonical 3-stage or Adapt DSL)
      ──► rnn_type ∈ {lstm, gru} stack  |  Mamba residual blocks
      ──► rnn_out "all" (flatten T·D) | "last" ([:, -1])
      ──► multiclass MLP head | per-class binary head

The backbone sees the flattened frames as an NCHW view in channels-last
memory (no copy). With ``compute_dtype="bfloat16"`` it runs under bf16
autocast and its features come back as f32, so the head always runs in f32
(the reference's promotion of bf16 features against f32 parameters). The
LSTM/GRU head runs the CUDA recurrences with ``scan_impl="pallas"`` and the
plain loops otherwise, as ``vct`` maps it. A backbone none of whose
parameters requires a gradient (frozen, the default) runs under
``torch.no_grad``, so training records no graph through it. A backbone that
trains (``model.finetune``) with ``model.remat_backbone`` on keeps none of
its activations through the head's forward and backward:
``torch.utils.checkpoint`` runs its forward again in the backward (``vct``'s
``nn.remat`` of the whole module). The recompute brings every activation
back before the backward runs through the backbone, so the step's peak
memory stays where it was; the step pays one more backbone forward. With
``model.seq_shard`` on a
rank mesh (``vct_torch.parallel``), the B·T frames of a rank's rows spread
over its model axis for the backbone (``vct``'s sequence parallelism).
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from vct_torch.core.config import ModelConfig
from vct_torch.models.backbones import build_backbone
from vct_torch.models.layers import AdaptDSL, CanonicalAdapter, MultiBinaryHead, MulticlassHead
from vct_torch.models.recurrent import RNNStack
from vct_torch.models.ssm import MambaResidualBlock
from vct_torch.parallel.mesh import ambient_mesh, gather_blocks

__all__ = ["LRCN", "backbone_features", "build_lrcn"]


def backbone_features(backbone: nn.Module, x, dtype: torch.dtype, mesh=None,
                      remat: bool = False):
    """(B, T, H, W, 3) clips -> (B, T, F) f32 features of ``backbone`` over
    the flattened B·T frames, under bf16 autocast when ``dtype`` is bf16;
    under ``torch.no_grad`` when no backbone parameter requires a gradient.
    Integer clips (raw uint8 into a stem with the 1/255 folded in) are cast
    to ``dtype`` first.

    With ``remat`` and a backbone that records a graph, the backbone runs
    under ``torch.utils.checkpoint`` (non-reentrant: the recompute in the
    backward keeps the autocast and RNG state), so the backward runs its
    forward again instead of keeping its activations.

    With ``mesh`` (a rank mesh whose model axis divides B·T), each rank runs
    the backbone over its 1/model slice of the frames and the features are
    joined over the model axis, gradients passed back to each rank's slice
    (``vct``'s ``seq_shard``)."""
    b, t = x.shape[0], x.shape[1]
    frames = x.reshape((b * t,) + tuple(x.shape[2:]))
    split = (mesh is not None and mesh.distributed and mesh.shape["model"] > 1
             and (b * t) % mesh.shape["model"] == 0)
    if split:
        frames = mesh.block(frames, 0, "model")
    # (frames, H, W, 3) -> NCHW view; its strides are channels-last already.
    frames = frames.permute(0, 3, 1, 2)
    if not frames.is_floating_point():
        frames = frames.to(dtype)  # 0-255 is exact in bf16
    grad = torch.is_grad_enabled() and any(p.requires_grad for p in backbone.parameters())
    run = (lambda f: checkpoint(backbone, f, use_reentrant=False)) if remat and grad else backbone
    with torch.set_grad_enabled(grad):
        if dtype == torch.bfloat16:
            with torch.autocast(device_type=frames.device.type, dtype=torch.bfloat16):
                feats = run(frames)
        else:
            feats = run(frames.to(dtype))
    feats = feats.to(torch.float32).reshape(frames.shape[0], -1)
    if split:
        feats = gather_blocks(feats, mesh, 0, "model")
    return feats.reshape(b, t, -1)


class LRCN(nn.Module):
    # Trainer's feature cache: features_only / from_features split the forward.
    supports_feature_cache = True

    def __init__(
        self,
        num_classes: int,
        sequence_length: int,
        hidden_size: int,
        rnn_input_size: int,
        cnn_backbone: str = "resnet50",
        rnn_type: str = "mamba",
        rnn_layer: int = 3,
        rnn_out: str = "all",
        bidirectional: bool = False,
        classif_mode: str = "multiclass",
        dropout: float = 0.25,
        adapt_mode: str = "",
        scan_impl: str = "associative",
        dtype: torch.dtype = torch.float32,
        seq_shard: bool = False,
        remat_backbone: bool = False,
    ):
        super().__init__()
        self.seq_shard = seq_shard
        self.remat_backbone = remat_backbone
        if rnn_out not in ("all", "last"):
            raise ValueError(f"rnn_out must be 'all' or 'last', got {rnn_out!r}")
        self.rnn_out = rnn_out
        self.rnn_type = rnn_type
        self.dtype = dtype
        self.cnn_backbone, feat = build_backbone(cnn_backbone)
        if adapt_mode:
            self.adapt = AdaptDSL(feat, rnn_input_size, mode=adapt_mode, dropout=dropout)
        else:
            self.adapt = CanonicalAdapter(feat, rnn_input_size, dropout=dropout)
        if rnn_type == "mamba":
            # Block i: ResidualBlock(rnn_input, 2*rnn_input, n_state=hidden,
            # dt_rank=hidden), named mamba_{i} as in the reference.
            self.blocks = [f"mamba_{i}" for i in range(rnn_layer)]
            for name in self.blocks:
                self.add_module(name, MambaResidualBlock(
                    d_model=rnn_input_size,
                    d_inner=rnn_input_size * 2,
                    n_state=hidden_size,
                    dt_rank=hidden_size,
                    bidirectional=bidirectional,
                    scan_impl=scan_impl,
                ))
            width = rnn_input_size
        else:
            self.rnn = RNNStack(
                rnn_type, rnn_input_size, hidden_size, rnn_layer, bidirectional=bidirectional,
                scan_impl="pallas" if scan_impl == "pallas" else "scan",
            )
            width = hidden_size * (2 if bidirectional else 1)
        pooled = width * (sequence_length if rnn_out == "all" else 1)
        if classif_mode == "multiclass":
            self.head = MulticlassHead(pooled, num_classes, dropout=dropout)
        else:
            self.head = MultiBinaryHead(pooled, num_classes)

    def forward(self, x, *, from_features: bool = False, features_only: bool = False):
        if from_features:
            return self._head(x)
        feats = backbone_features(self.cnn_backbone, x, self.dtype,
                                  ambient_mesh() if self.seq_shard else None,
                                  remat=self.remat_backbone)
        if features_only:
            return feats
        return self._head(feats)

    def _head(self, feats):
        h = self.adapt(feats.to(torch.float32))
        if self.rnn_type == "mamba":
            for name in self.blocks:
                h = getattr(self, name)(h)
        else:
            h = self.rnn(h)
        pooled = h.reshape(h.shape[0], -1) if self.rnn_out == "all" else h[:, -1, :]
        return self.head(pooled)


def build_lrcn(cfg: ModelConfig, sequence_length: int) -> LRCN:
    dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32
    return LRCN(
        num_classes=cfg.num_classes,
        sequence_length=sequence_length,
        hidden_size=cfg.resolved_hidden_size,
        rnn_input_size=cfg.rnn_input_size,
        cnn_backbone=cfg.cnn_backbone,
        rnn_type=cfg.rnn_type,
        rnn_layer=cfg.rnn_layer,
        rnn_out=cfg.rnn_out,
        bidirectional=cfg.bidirectional,
        classif_mode=cfg.classif_mode,
        dropout=cfg.dropout,
        adapt_mode=cfg.adapt if cfg.use_adapt_dsl else "",
        scan_impl=cfg.scan_impl,
        dtype=dtype,
        seq_shard=cfg.seq_shard,
        remat_backbone=cfg.remat_backbone,
    )
