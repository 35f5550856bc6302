"""Model construction: the registry of model families and seeded weights."""

from __future__ import annotations

import math

import torch
from torch import nn

from vct_torch.core.registry import Registry
from vct_torch.device import resolve_device
from vct_torch.models.layers import RMSNorm
from vct_torch.models.lrcn import LRCN, build_lrcn
from vct_torch.models.recurrent import GRU, LSTM
from vct_torch.models.scratch_cnn import LRCN2, TimeDistributedCNNLSTM
from vct_torch.models.ssm import ParallelMamba
from vct_torch.models.videomamba import VideoMamba, build_videomamba

__all__ = ["LRCN", "LRCN2", "MODEL_FAMILIES", "TimeDistributedCNNLSTM", "VideoMamba",
           "build_lrcn", "build_model", "build_videomamba", "init_weights"]

MODEL_FAMILIES = Registry("model_family")
MODEL_FAMILIES.register("lrcn", build_lrcn)
MODEL_FAMILIES.register("videomamba", build_videomamba)


def _normal(shape, std: float, gen: torch.Generator) -> torch.Tensor:
    return torch.randn(shape, generator=gen, dtype=torch.float32) * std


@torch.no_grad()
def init_weights(model: nn.Module, seed: int = 0) -> nn.Module:
    """Fill every parameter and buffer from a seeded CPU generator.

    The scheme follows the reference's initializers: LeCun-normal conv and
    linear weights, zero biases, unit norms, BN statistics (0, 1),
    standard-normal ``A_log`` / ``D`` and embeddings (torch's
    ``nn.Embedding``), and LSTM/GRU weights and biases U(-1/sqrt(H),
    1/sqrt(H)). The same seed gives the same weights on any
    device.
    """
    gen = torch.Generator(device="cpu").manual_seed(seed)
    values = {}
    for mod in model.modules():
        if isinstance(mod, (nn.Conv1d, nn.Conv2d, nn.Linear)):
            w = mod.weight
            fan_in = w.shape[1] * math.prod(w.shape[2:]) if w.dim() > 2 else w.shape[1]
            if isinstance(mod, nn.Conv1d):  # depthwise: the reference's (k, D) kernel
                fan_in = w.shape[-1]
            values[id(w)] = _normal(w.shape, 1.0 / math.sqrt(fan_in), gen)
            if mod.bias is not None:
                values[id(mod.bias)] = torch.zeros(mod.bias.shape)
        elif isinstance(mod, (nn.LayerNorm, nn.BatchNorm2d)):
            values[id(mod.weight)] = torch.ones(mod.weight.shape)
            values[id(mod.bias)] = torch.zeros(mod.bias.shape)
            if isinstance(mod, nn.BatchNorm2d):
                values[id(mod.running_mean)] = torch.zeros(mod.running_mean.shape)
                values[id(mod.running_var)] = torch.ones(mod.running_var.shape)
                values[id(mod.num_batches_tracked)] = torch.zeros((), dtype=torch.long)
        elif isinstance(mod, RMSNorm):
            values[id(mod.weight)] = torch.ones(mod.weight.shape)
        elif isinstance(mod, ParallelMamba):
            values[id(mod.A_log)] = _normal(mod.A_log.shape, 1.0, gen)
            values[id(mod.D)] = _normal(mod.D.shape, 1.0, gen)
        elif isinstance(mod, nn.Embedding):
            values[id(mod.weight)] = _normal(mod.weight.shape, 1.0, gen)
        elif isinstance(mod, (LSTM, GRU)) or getattr(mod, "recurrent_params", False):
            # The captioners' step cells mark their own recurrence weights.
            k = mod.hidden_size ** -0.5
            for p in mod.parameters(recurse=False):
                values[id(p)] = torch.rand(p.shape, generator=gen) * (2 * k) - k
    tensors = list(model.parameters()) + list(model.buffers())
    missing = [t for t in tensors if id(t) not in values]
    if missing:
        raise ValueError(f"init_weights has no rule for {len(missing)} tensors")
    for t in tensors:
        t.copy_(values[id(t)])
    return model


def _build(model_cfg, sequence_length: int, frame_size) -> nn.Module:
    """The model family dispatch of ``vct/models/__init__.py``."""
    if model_cfg.model_family in MODEL_FAMILIES:
        return MODEL_FAMILIES.get(model_cfg.model_family)(model_cfg, sequence_length)
    if model_cfg.model_family == "lrcn2":
        if frame_size is None:
            raise ValueError("model_family lrcn2 needs frame_size: its GRU's input width "
                             "is 64 * (H // 4) * (W // 4)")
        return LRCN2(num_classes=model_cfg.num_classes, sequence_length=sequence_length,
                     hidden_size=model_cfg.resolved_hidden_size, frame_size=tuple(frame_size))
    if model_cfg.model_family == "td_cnn_lstm":
        return TimeDistributedCNNLSTM(num_classes=model_cfg.num_classes)
    raise KeyError(f"Unknown model family: {model_cfg.model_family}; available: "
                   f"{MODEL_FAMILIES.names() + ['lrcn2', 'td_cnn_lstm']}")


def build_model(model_cfg, sequence_length: int, device=None, seed: int = 0,
                frame_size=None) -> nn.Module:
    """Build the configured model family on ``device`` (default: the card)
    with weights from ``seed``, in eval mode. ``frame_size`` (H, W) is
    needed by ``lrcn2`` alone. Load trained weights with
    ``vct_torch.bridge.load_vct_variables``."""
    dev = resolve_device(device)
    with torch.device("meta"):
        model = _build(model_cfg, sequence_length, frame_size)
    model.to_empty(device=dev)
    init_weights(model, seed)
    return model.to(memory_format=torch.channels_last).eval()
