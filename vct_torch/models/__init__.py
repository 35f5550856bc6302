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
from vct_torch.models.ssm import ParallelMamba

__all__ = ["LRCN", "MODEL_FAMILIES", "build_lrcn", "build_model", "init_weights"]

MODEL_FAMILIES = Registry("model_family")
MODEL_FAMILIES.register("lrcn", build_lrcn)


def _normal(shape, std: float, gen: torch.Generator) -> torch.Tensor:
    return torch.randn(shape, generator=gen, dtype=torch.float32) * std


@torch.no_grad()
def init_weights(model: nn.Module, seed: int = 0) -> nn.Module:
    """Fill every parameter and buffer from a seeded CPU generator.

    The scheme follows the reference's initializers: LeCun-normal conv and
    linear weights, zero biases, unit norms, BN statistics (0, 1),
    standard-normal ``A_log`` / ``D``, and LSTM/GRU weights and biases
    U(-1/sqrt(H), 1/sqrt(H)). The same seed gives the same weights on any
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
        elif isinstance(mod, (LSTM, GRU)):
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


def build_model(model_cfg, sequence_length: int, device=None, seed: int = 0) -> nn.Module:
    """Build the configured model family on ``device`` (default: the card)
    with weights from ``seed``, in eval mode. Load trained weights with
    ``vct_torch.bridge.load_vct_variables``."""
    dev = resolve_device(device)
    build = MODEL_FAMILIES.get(model_cfg.model_family)  # KeyError lists the ported ones
    with torch.device("meta"):
        model = build(model_cfg, sequence_length)
    model.to_empty(device=dev)
    init_weights(model, seed)
    return model.to(memory_format=torch.channels_last).eval()
