"""A whole reference-LRCN, VideoMamba or S2VT torch state_dict into the port's
model: the port of ``vct/models/lrcn_port.py``.

The reference checkpoints whole torch modules (``train_eval.py:53``
``torch.save(model)``); a user exports ``torch.load(path).state_dict()``
and runs ``python -m vct_torch.tools.port_reference`` to get a vct_torch
checkpoint the serving path loads (``vct_torch.serve.deployment.load_model``).

The layout consumed (``medsos_lrcn/src/models.py:121-186``), and where each
part lands in the port's modules:

    cnn_backbone.*                        torchvision backbone (its porter)
    adapt{1,2,3}.*, bn{1,2,3}.*           adapt.adapt{1,2,3}, adapt.bn{1,2,3}
    rnn.weight_ih_l{i}[_reverse] ...      rnn.{lstm,gru}.* , weights transposed
                                          to the port's (in, G*H) layout
    rnn.{i}.norm.weight, rnn.{i}.mixer.*  mamba_{i}.norm, mamba_{i}.mixer
                                          (the mixer's ``conv1d`` is ``conv``)
    bn0/fc/bna/fca/bnb/fcb.*              head.* (multiclass MLP head)
    fc.{i}.weight/bias                    head.binary_heads, the per-class
                                          heads fused into one Linear

Strict: every tensor a porter reads is tracked per key, so a tensor no
porter touched (the ``*_reverse`` half of a bidirectional checkpoint ported
with ``bidirectional=False``) raises ``ValueError``, as does a shape that
does not match the model; a tensor the layout needs and the state_dict
lacks raises ``KeyError``. Nothing is written unless everything maps.
``port_reference_videomamba`` does the same for a reference VideoMamba
(``cnn_backbone``, ``adapt``, ``layers.{i}.norm/mixer`` -> ``layer_{i}``,
``norm_f``, ``classifier``), and ``port_reference_s2vt`` for a reference
S2VT captioner (``cnn.model`` the backbone, ``cnn.fc``, ``encoder.*``,
``decoder.*``).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

from vct_torch.models.backbones.port import load_torch_backbone, torch_tensor_dict

__all__ = ["port_reference_lrcn", "port_reference_videomamba", "port_reference_s2vt"]


class _ConsumeTracker:
    """A state_dict that records exactly which keys are read, so the
    consume-everything check flags any tensor no porter touched."""

    def __init__(self, data: Dict[str, np.ndarray]):
        self.data = data
        self.consumed = set()

    def __getitem__(self, key):
        if key not in self.data:
            raise KeyError(f"Missing tensor in state_dict: {key}")
        self.consumed.add(key)
        return self.data[key]

    def consume_region(self, prefix: str) -> Dict[str, np.ndarray]:
        """Mark every key under ``prefix.`` consumed and return the sub-dict
        (for a sub-porter with its own strict per-key checks)."""
        sub = {}
        for k, v in self.data.items():
            if k.startswith(prefix + "."):
                self.consumed.add(k)
                sub[k[len(prefix) + 1:]] = v
        return sub

    def leftovers(self):
        return sorted(k for k in self.data
                      if k not in self.consumed and not k.endswith("num_batches_tracked"))


def _copy(out: Dict[str, np.ndarray], sd: _ConsumeTracker, ours: str, theirs: str,
          names=("weight", "bias")) -> None:
    for name in names:
        out[f"{ours}.{name}"] = sd[f"{theirs}.{name}"]


def _port_rnn(out, sd, ours: str, bidirectional: bool, num_layers: int) -> None:
    for layer in range(num_layers):
        for suffix in ("", "_reverse")[:2 if bidirectional else 1]:
            for kind in ("weight_ih", "weight_hh", "bias_ih", "bias_hh"):
                key = f"{kind}_l{layer}{suffix}"
                v = sd[f"rnn.{key}"]
                out[f"{ours}.{key}"] = np.transpose(v) if kind.startswith("weight") else v


def _port_mixer(out, sd, ours: str, theirs: str) -> None:
    for name in ("A_log", "D"):
        out[f"{ours}.{name}"] = sd[f"{theirs}.{name}"]
    _copy(out, sd, f"{ours}.conv", f"{theirs}.conv1d")
    for lin in ("in_proj", "dt_proj", "out_proj"):
        _copy(out, sd, f"{ours}.{lin}", f"{theirs}.{lin}")
    _copy(out, sd, f"{ours}.x_proj", f"{theirs}.x_proj", names=("weight",))


def _check(model: nn.Module, staged: Dict[str, np.ndarray], sd: _ConsumeTracker,
           skip: str) -> Dict[str, torch.Tensor]:
    """The consume-everything check, and every staged tensor against the
    model's tensors outside ``skip`` (the backbone, ported on its own):
    each present and of its shape. Returns the model's state_dict."""
    leftovers = sd.leftovers()
    if leftovers:
        raise ValueError(f"Unconsumed state_dict tensors (the config does not describe "
                         f"this checkpoint): {leftovers[:8]}...")
    target = model.state_dict()
    unported = sorted(k for k in target if k not in staged and not k.startswith(skip))
    if unported:
        raise KeyError(f"No state_dict tensor for the model's {unported[:8]}...")
    for name, value in staged.items():
        if name not in target:
            raise ValueError(f"the model has no tensor {name}")
        if tuple(np.shape(value)) != tuple(target[name].shape):
            raise ValueError(f"{name}: ported shape {tuple(np.shape(value))} != model "
                             f"{tuple(target[name].shape)}")
    return target


def _finish(model: nn.Module, staged: Dict[str, np.ndarray], sd: _ConsumeTracker,
            backbone_name: str, ours: str = "cnn_backbone",
            theirs: str = "cnn_backbone") -> nn.Module:
    """Check the staged tensors and the backbone region (``theirs`` in the
    state_dict, the submodule ``ours`` in the model), then write: the
    backbone porter checks and copies its part, and only after it the rest
    is copied."""
    backbone_sd = sd.consume_region(theirs)
    target = _check(model, staged, sd, skip=ours + ".")
    load_torch_backbone(backbone_name, model.get_submodule(ours), backbone_sd)
    with torch.no_grad():
        for name, value in staged.items():
            target[name].copy_(torch.from_numpy(np.array(value)).to(target[name].dtype))
    return model


def _fused_heads(sd: _ConsumeTracker, prefix: str, n: int):
    """A ModuleList of per-class Linear(F, 1) -> one Linear(F, n)."""
    return (np.concatenate([sd[f"{prefix}.{i}.weight"] for i in range(n)]),
            np.concatenate([sd[f"{prefix}.{i}.bias"] for i in range(n)]))


def port_reference_lrcn(model: nn.Module, state_dict, model_cfg) -> nn.Module:
    """Port a reference LRCN state_dict into the port's ``model`` in place
    (an ``LRCN`` built from ``model_cfg``, the ``ModelConfig`` that
    describes the checkpoint: backbone, rnn_type, sizes, classif_mode).
    Returns the model; raises ``KeyError`` / ``ValueError`` on mismatches."""
    sd = _ConsumeTracker(torch_tensor_dict(state_dict))
    staged: Dict[str, np.ndarray] = {}
    for i in (1, 2, 3):
        _copy(staged, sd, f"adapt.adapt{i}", f"adapt{i}")
        _copy(staged, sd, f"adapt.bn{i}", f"bn{i}")
    if model_cfg.rnn_type == "mamba":
        for i in range(model_cfg.rnn_layer):
            staged[f"mamba_{i}.norm.weight"] = sd[f"rnn.{i}.norm.weight"]
            _port_mixer(staged, sd, f"mamba_{i}.mixer", f"rnn.{i}.mixer")
    else:
        _port_rnn(staged, sd, f"rnn.{model_cfg.rnn_type}", model_cfg.bidirectional,
                  model_cfg.rnn_layer)
    if model_cfg.classif_mode == "multiclass":
        for name in ("bn0", "fc", "bna", "fca", "bnb", "fcb"):
            _copy(staged, sd, f"head.{name}", name)
    else:
        staged["head.binary_heads.weight"], staged["head.binary_heads.bias"] = _fused_heads(
            sd, "fc", model_cfg.num_classes)
    return _finish(model, staged, sd, model_cfg.cnn_backbone)


def port_reference_videomamba(model: nn.Module, state_dict, model_cfg) -> nn.Module:
    """Port a reference VideoMamba state_dict (``lrcn/videomamba.py:332-386``:
    ``cnn_backbone``, one Linear ``adapt``, ``layers.{i}.norm/mixer``
    residual blocks, ``norm_f``, a ``classifier`` Linear or a
    ``classifier.{i}`` list of per-class Linears for multiple_binary) into
    the port's ``VideoMamba`` ``model`` in place, ``model_cfg`` its
    ``ModelConfig``. Returns the model; raises ``KeyError`` / ``ValueError``
    on mismatches, having written nothing."""
    sd = _ConsumeTracker(torch_tensor_dict(state_dict))
    staged: Dict[str, np.ndarray] = {}
    _copy(staged, sd, "adapt", "adapt")
    for i in range(model_cfg.vm_n_layer):
        staged[f"layer_{i}.norm.weight"] = sd[f"layers.{i}.norm.weight"]
        _port_mixer(staged, sd, f"layer_{i}.mixer", f"layers.{i}.mixer")
    staged["norm_f.weight"] = sd["norm_f.weight"]
    if model_cfg.classif_mode == "multiclass":
        _copy(staged, sd, "classifier", "classifier")
    else:
        staged["classifier.weight"], staged["classifier.bias"] = _fused_heads(
            sd, "classifier", model_cfg.num_classes)
    return _finish(model, staged, sd, model_cfg.cnn_backbone)


def _backbone_family(keys) -> str:
    """The torchvision family of a backbone state_dict, from its keys (the
    reference's PretrainedCNN offers resnet50, vgg16, inception_v3 and
    mobilenet_v2); the ResNets share one porter, so only the block tells
    resnet50 from resnet18."""
    if any(k.startswith("features.denseblock") for k in keys):
        return "densenet121"
    if any(k.startswith("Mixed_") for k in keys):
        return "inception_v3"
    if "features.18.0.weight" in keys:
        return "mobilenet_v2"
    if "features.0.weight" in keys:
        return "vgg16"
    return "resnet50" if "layer1.0.conv3.weight" in keys else "resnet18"


def port_reference_s2vt(model: nn.Module, state_dict) -> nn.Module:
    """Port a reference VideoAnalysisModel state_dict
    (``s2vt/beam_search.py:362-382``) into the port's v2 ``S2VTModel``
    ``model`` in place (``vct_torch.caption.models``, one GRU layer).

    Layout consumed: ``cnn.model.*`` (the torchvision backbone with its
    discarded fc; the family inferred from its keys), ``cnn.fc.*`` (the
    projection), ``encoder.embedding/gru``,
    ``decoder.embedding/attention.attn/gru/out``. The reference's
    ``cnn.feature_extractor.*`` entries duplicate ``cnn.model.*``
    (PretrainedCNN registers the same children twice, beam_search.py:
    265-267) and are dropped. Returns the model; raises ``KeyError`` /
    ``ValueError`` on mismatches, having written nothing."""
    sd = _ConsumeTracker({k: v for k, v in torch_tensor_dict(state_dict).items()
                          if not k.startswith("cnn.feature_extractor.")})
    family = _backbone_family([k[len("cnn.model."):] for k in sd.data
                               if k.startswith("cnn.model.")])
    staged: Dict[str, np.ndarray] = {}
    _copy(staged, sd, "cnn.fc", "cnn.fc")
    _copy(staged, sd, "encoder.embedding", "encoder.embedding")
    for kind in ("weight_ih", "weight_hh", "bias_ih", "bias_hh"):
        v = sd[f"encoder.gru.{kind}_l0"]
        staged[f"encoder.gru.{kind}_l0"] = np.transpose(v) if kind.startswith("weight") else v
    staged["decoder.embedding.weight"] = sd["decoder.embedding.weight"]
    _copy(staged, sd, "decoder.attention.attn", "decoder.attention.attn")
    for ours, kind in (("gru_w_ih", "weight_ih"), ("gru_w_hh", "weight_hh"),
                       ("gru_b_ih", "bias_ih"), ("gru_b_hh", "bias_hh")):
        v = sd[f"decoder.gru.{kind}_l0"]
        staged[f"decoder.{ours}"] = np.transpose(v) if kind.startswith("weight") else v
    _copy(staged, sd, "decoder.out", "decoder.out")
    return _finish(model, staged, sd, family, ours="cnn.cnn", theirs="cnn.model")
