"""Scratch (non-pretrained) CNN-RNN models: the ``lrcn2`` and
``td_cnn_lstm`` families.

Port of ``vct/models/scratch_cnn.py``:

* ``LRCN2``: three 3x3 convs (with bias), each with BatchNorm and ReLU, max
  pools after the last two, dropout, a bidirectional GRU over the flattened
  conv maps, a Linear head over all steps (the reference's
  ``lrcn/backup_ucf50.py:105-151``). Its BatchNorm trains on batch
  statistics in train mode, as ``vct`` runs it (Flax's update: running
  statistics times 0.9 plus the batch's times 0.1, the batch variance
  biased) and runs at its running statistics in eval mode.
* ``TimeDistributedCNNLSTM``: three conv + max-pool + dropout stages, a
  global average pool (``vct``'s fix of the reference's 64-feature
  contract), an LSTM of H=32, a Linear head on the last step
  (``lrcn/pretrain-lrcn.py:101-156``).

Both recurrences take ``vct``'s default ``scan_impl="scan"``, the plain
loops of ``vct_torch.models.recurrent``: no kernel runs on these heads, as
in ``vct``. The GRU's input width follows from the frame size
(64 · H/4 · W/4), which ``LRCN2`` therefore takes at construction. Conv maps
are flattened in (h, w, c) order, as ``vct`` flattens its NHWC maps.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from vct_torch.models.layers import Dropout
from vct_torch.parallel.mesh import ambient_mesh, sum_over
from vct_torch.models.recurrent import GRU, LSTM

__all__ = ["LRCN2", "TimeDistributedCNNLSTM"]

_MOMENTUM = 0.9  # Flax's BatchNorm momentum in vct


class _BatchStatsNorm(nn.BatchNorm2d):
    """BatchNorm with Flax's training semantics: batch statistics in train
    mode (the variance biased, E[x²] - E[x]²; over the global batch on a
    rank of a mesh), the running ones updated as ``m * running + (1 - m) *
    batch``; running statistics in eval mode."""

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        mesh = ambient_mesh()
        if mesh is not None and mesh.distributed and mesh.shape["data"] > 1:
            # The statistics of the global batch, as vct's one program has
            # them: sums over the data axis's ranks (their gradients too).
            count = x.shape[0] * x.shape[2] * x.shape[3] * mesh.shape["data"]
            sums = sum_over(torch.stack([x.sum(dim=(0, 2, 3)), (x * x).sum(dim=(0, 2, 3))]),
                            mesh, "data")
            mean, sq = sums[0] / count, sums[1] / count
        else:
            mean, sq = x.mean(dim=(0, 2, 3)), (x * x).mean(dim=(0, 2, 3))
        var = torch.clamp_min(sq - mean * mean, 0.0)
        with torch.no_grad():
            self.running_mean.mul_(_MOMENTUM).add_(mean.detach(), alpha=1 - _MOMENTUM)
            self.running_var.mul_(_MOMENTUM).add_(var.detach(), alpha=1 - _MOMENTUM)
        scale = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean[:, None, None]) * scale[:, None, None] + self.bias[:, None, None]


def _conv3(cin: int, cout: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, padding=1)


def _frames(x):
    """(B, T, H, W, C) -> (B·T, C, H, W), a channels-last view."""
    b, t = x.shape[0], x.shape[1]
    return x.reshape((b * t,) + tuple(x.shape[2:])).permute(0, 3, 1, 2)


class LRCN2(nn.Module):
    def __init__(self, num_classes: int, sequence_length: int, hidden_size: int,
                 frame_size: Tuple[int, int], dropout: float = 0.3):
        super().__init__()
        self.conv1, self.bn1 = _conv3(3, 16), _BatchStatsNorm(16, eps=1e-5)
        self.conv2, self.bn2 = _conv3(16, 32), _BatchStatsNorm(32, eps=1e-5)
        self.conv3, self.bn3 = _conv3(32, 64), _BatchStatsNorm(64, eps=1e-5)
        self.drop = Dropout(dropout)
        height, width = frame_size
        self.gru = GRU(64 * (height // 4) * (width // 4), hidden_size, 1, bidirectional=True)
        self.fc = nn.Linear(sequence_length * 2 * hidden_size, num_classes)

    def forward(self, x):
        b, t = x.shape[0], x.shape[1]
        h = F.relu(self.bn1(self.conv1(_frames(x))))
        h = F.max_pool2d(F.relu(self.bn2(self.conv2(h))), 2, stride=2)
        h = F.max_pool2d(F.relu(self.bn3(self.conv3(h))), 2, stride=2)
        h = self.drop(h).permute(0, 2, 3, 1).reshape(b, t, -1)
        return self.fc(self.gru(h).reshape(b, -1))


class TimeDistributedCNNLSTM(nn.Module):
    def __init__(self, num_classes: int = 5, dropout: float = 0.25):
        super().__init__()
        self.conv1, self.conv2, self.conv3 = _conv3(3, 16), _conv3(16, 32), _conv3(32, 64)
        self.drop = Dropout(dropout)
        self.lstm = LSTM(64, 32, 1)
        self.fc1 = nn.Linear(32, num_classes)

    def forward(self, x):
        b, t = x.shape[0], x.shape[1]
        h = _frames(x)
        for conv in (self.conv1, self.conv2, self.conv3):
            h = self.drop(F.max_pool2d(conv(h), 2, stride=2))
        h = h.mean(dim=(2, 3)).reshape(b, t, -1)
        return self.fc1(self.lstm(h)[:, -1, :])
