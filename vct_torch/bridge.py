"""Load a ``vct`` (Flax) variables tree into the port's modules.

The inverse of ``vct/models/backbones/port.py``, extended to every model
family (LRCN, VideoMamba, LRCN2, TimeDistributedCNNLSTM) and every
captioner (S2VT, 1s2vt, transformer, v1 LSTM/GRU).
The port's submodules carry the Flax module names (``cnn_backbone.layer1_0
.conv1``, ``adapt.adapt1``, ``mamba_0.mixer.in_proj``, ``head.fc`` ...), so
each torch tensor's Flax leaf follows from its module path and type:

=====================================  =====================================
Flax                                   torch
=====================================  =====================================
conv ``kernel`` (kH, kW, I, O)         Conv2d ``weight`` (O, I, kH, kW)
(depthwise: (kH, kW, 1, C))            (depthwise: (C, 1, kH, kW))
Dense ``kernel`` (in, out)             Linear ``weight`` (out, in)
attention ``query/key/value`` kernel   Linear ``weight`` (heads*head_dim, in),
(in, heads, head_dim), bias            bias (heads*head_dim,): the module's
(heads, head_dim); ``out`` kernel      ``flax_kernel_shape`` / ``flax_bias_shape``
(heads, head_dim, out)                 say Flax's; ``out``: (out, heads*head_dim)
Embed ``embedding`` (V, F)             Embedding ``weight`` (V, F)
LayerNorm ``scale``                    LayerNorm ``weight``
BatchNorm ``{scale,bias}``             BatchNorm2d ``weight``, ``bias``
``batch_stats .../{mean,var}``         ``running_mean``, ``running_var``
(ResNet: ``.../bnN/BatchNorm_0/...``)  (the module's ``flax_child``)
Mamba ``conv_kernel`` (k, D)           depthwise Conv1d ``weight`` (D, 1, k)
Mamba ``conv_bias``                    depthwise Conv1d ``bias``
``A_log``, ``D``, RMSNorm ``weight``   the same names, as they are
=====================================  =====================================

Strict like the reference's porter: a leaf the model needs but the tree
lacks raises ``KeyError``; a leaf the model does not consume, or a shape
mismatch, raises ``ValueError``. Nothing is written unless every tensor maps.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

__all__ = ["load_vct_variables"]


def _flatten(tree, prefix: str, out: Dict[str, np.ndarray]) -> None:
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(value, Mapping):
            _flatten(value, path, out)
        else:
            out[path] = np.asarray(value)


class _Leaves:
    def __init__(self, variables: Mapping):
        self.leaves: Dict[str, np.ndarray] = {}
        for col in ("params", "batch_stats"):
            if col in variables:
                _flatten(variables[col], col, self.leaves)
        self.consumed = set()

    def take(self, path: str) -> np.ndarray:
        if path not in self.leaves:
            raise KeyError(f"Missing leaf in the vct variables: {path}")
        self.consumed.add(path)
        return self.leaves[path]


def _dense_general(path: str, shape, rows):
    """A Flax ``DenseGeneral`` leaf of ``shape`` -> the Linear's layout: the
    kernel flattened to (in, out) and transposed (``rows`` = in), the bias
    flattened. Any other shape raises ``ValueError``."""
    def transform(w):
        if tuple(w.shape) != tuple(shape):
            raise ValueError(f"{path}: shape {tuple(w.shape)} != expected {tuple(shape)}")
        return w.reshape(-1) if rows is None else np.transpose(w.reshape(rows, -1))
    return transform


def _sources(mod: nn.Module, mname: str):
    """(torch tensor name, flax leaf path, transform) for each of ``mod``'s
    own tensors."""
    p = "/".join(["params"] + ([mname.replace(".", "/")] if mname else []))
    if isinstance(mod, nn.Conv2d):
        yield "weight", f"{p}/kernel", lambda w: np.transpose(w, (3, 2, 0, 1))
        if mod.bias is not None:
            yield "bias", f"{p}/bias", None
    elif isinstance(mod, nn.Conv1d):
        # The Mamba mixer's depthwise conv: its parameters live on the mixer.
        parent = p.rsplit("/", 1)[0]
        yield "weight", f"{parent}/conv_kernel", lambda w: np.transpose(w)[:, None, :]
        if mod.bias is not None:
            yield "bias", f"{parent}/conv_bias", None
    elif isinstance(mod, nn.Linear):
        kernel = getattr(mod, "flax_kernel_shape", None)
        if kernel is None:
            yield "weight", f"{p}/kernel", np.transpose
            if mod.bias is not None:
                yield "bias", f"{p}/bias", None
        else:  # a DenseGeneral: the attention's heads are axes of their own
            yield "weight", f"{p}/kernel", _dense_general(p, kernel, mod.in_features)
            yield "bias", f"{p}/bias", _dense_general(p, mod.flax_bias_shape, None)
    elif isinstance(mod, nn.Embedding):
        yield "weight", f"{p}/embedding", None
    elif isinstance(mod, nn.LayerNorm):
        yield "weight", f"{p}/scale", None
        yield "bias", f"{p}/bias", None
    elif isinstance(mod, nn.BatchNorm2d):
        # The module says where Flax keeps its variables: ResNet's ``_BN``
        # wraps its BatchNorm (``flax_child = "BatchNorm_0"``); every other
        # family names the BatchNorm itself.
        child = getattr(mod, "flax_child", "")
        p = f"{p}/{child}" if child else p
        stats = p.replace("params", "batch_stats", 1)
        yield "weight", f"{p}/scale", None
        yield "bias", f"{p}/bias", None
        yield "running_mean", f"{stats}/mean", None
        yield "running_var", f"{stats}/var", None
    else:
        for name, _ in mod.named_parameters(recurse=False):
            yield name, f"{p}/{name}", None


@torch.no_grad()
def load_vct_variables(model: nn.Module, variables: Mapping) -> nn.Module:
    """Copy a ``vct`` ``{'params', 'batch_stats'}`` tree of arrays into
    ``model`` (a port module built with the matching config)."""
    leaves = _Leaves(variables)
    staged = []
    for mname, mod in model.named_modules():
        for tname, path, transform in _sources(mod, mname):
            value = leaves.take(path)
            if transform is not None:
                value = transform(value)
            dst = getattr(mod, tname)
            if tuple(value.shape) != tuple(dst.shape):
                raise ValueError(
                    f"{path} -> {mname}.{tname}: shape {tuple(value.shape)} "
                    f"!= expected {tuple(dst.shape)}"
                )
            staged.append((dst, value))
    leftovers = sorted(set(leaves.leaves) - leaves.consumed)
    if leftovers:
        raise ValueError(f"Unconsumed vct leaves: {leftovers[:8]}...")
    for dst, value in staged:
        dst.copy_(torch.from_numpy(np.array(value)).to(dst.dtype))
    return model
