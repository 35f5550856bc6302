"""Parameter sharding rules (tensor parallelism over the ``model`` axis):
the port of ``vct/parallel/shard.py``.

The rule is ``vct``'s, read on each torch parameter's ``vct`` leaf (the
bridge's mapping, ``vct_torch.bridge._sources``): a parameter column-shards
over ``model`` when one segment of its leaf's path is ``adapt``, ``head``,
``rnn`` or ``classifier``, or is ``mamba_<digits>`` / ``layer_<digits>``
(anchored: ``layer1_0`` does not match), no segment is ``cnn_backbone`` or
``cnn``, the leaf has two dimensions or more, and its last dimension is a
multiple of the model size and at least that size. The torch dimension that
carries the leaf's last one follows from the same mapping: dim 0 of a
``Linear`` weight (the kernel is transposed), dim 0 of the Mamba mixer's
depthwise ``Conv1d`` weight, the last dim of a tensor kept as it is.

Each rank of a rank mesh keeps only its block of such a parameter (and of
its Adam moments); the trainer joins the blocks before a forward
(``gather_params``) and each rank updates its own.
"""

from __future__ import annotations

import itertools
from typing import Dict, Optional, Tuple

import numpy as np

from vct_torch.parallel.mesh import MODEL_AXIS, gather_blocks

__all__ = ["param_pspec", "param_specs", "shard_params", "shard_state_like_params",
           "gather_params", "full_tensor"]

_TP_SEGMENTS = frozenset({"adapt", "head", "rnn", "classifier"})
_TP_SEGMENT_PREFIXES = ("mamba_", "layer_")
_EXCLUDED_SEGMENTS = frozenset({"cnn_backbone", "cnn"})


def _is_tp_path(segments) -> bool:
    if any(s in _EXCLUDED_SEGMENTS for s in segments):
        return False
    for s in segments:
        if s in _TP_SEGMENTS:
            return True
        for prefix in _TP_SEGMENT_PREFIXES:
            # anchored: "mamba_0" / "layer_3" match, "layer1_0" does not
            if s.startswith(prefix) and s[len(prefix):].isdigit():
                return True
    return False


def _leaf_shape_and_dim(transform, shape: Tuple[int, ...]) -> Tuple[Tuple[int, ...], int]:
    """The ``vct`` leaf's shape, and the torch dim that carries the leaf's
    last dim, for a torch tensor of ``shape`` that the bridge fills with
    ``transform(leaf)``. The transforms permute axes (and the Conv1d's adds
    one of size 1), so the leaf's shape is the one arrangement of the
    tensor's dims (its size-1 dims dropped or kept) that the transform maps
    onto ``shape``; a probe counting along the leaf's last axis shows where
    that axis lands."""
    if transform is None:
        return shape, len(shape) - 1
    core = tuple(d for d in shape if d != 1)
    for dims in (shape, core):
        for order in itertools.permutations(range(len(dims))):
            leaf = tuple(dims[i] for i in order)
            if not leaf:
                continue
            probe = np.broadcast_to(np.arange(leaf[-1]), leaf)
            try:
                out = np.asarray(transform(probe))
            except ValueError:
                continue
            if out.shape != shape:
                continue
            for d, size in enumerate(shape):
                along = np.arange(size).reshape([-1 if i == d else 1 for i in range(len(shape))])
                if size == leaf[-1] and np.array_equal(out, np.broadcast_to(along, shape)):
                    return leaf, d
    raise ValueError(f"no vct leaf maps onto a tensor of shape {shape}")


def param_specs(model, model_size: int) -> Dict[str, int]:
    """{parameter name: the torch dim that shards over ``model``} for every
    parameter of ``model`` that ``vct``'s rule column-shards at
    ``model_size``."""
    from vct_torch.bridge import _sources

    params = dict(model.named_parameters())
    specs = {}
    for mname, mod in model.named_modules():
        for tname, path, transform in _sources(mod, mname):
            name = f"{mname}.{tname}" if mname else tname
            if name not in params:
                continue  # a buffer (BatchNorm's running statistics)
            dim = _spec(path, transform, tuple(params[name].shape), model_size)
            if dim is not None:
                specs[name] = dim
    return specs


def _spec(path: str, transform, shape, model_size: int) -> Optional[int]:
    segments = path.split("/")[1:]
    if not _is_tp_path(segments):
        return None
    leaf, dim = _leaf_shape_and_dim(transform, shape)
    if len(leaf) >= 2 and leaf[-1] % model_size == 0 and leaf[-1] >= model_size:
        return dim
    return None


def param_pspec(name: str, tensor, model_size: int, model) -> Optional[int]:
    """The torch dim of ``model``'s parameter ``name`` (``tensor``) that
    shards over the model axis at ``model_size``, or None where it stays
    whole (``vct``'s ``param_pspec``, whose ``PartitionSpec`` names the
    leaf's last dim)."""
    from vct_torch.bridge import _sources

    mname, _, tname = name.rpartition(".")
    mod = model.get_submodule(mname) if mname else model
    for t, path, transform in _sources(mod, mname):
        if t == tname:
            return _spec(path, transform, tuple(tensor.shape), model_size)
    return None


def shard_params(model, mesh) -> Dict[str, int]:
    """Keep on this rank only its block of each parameter the rule shards
    (the ``data`` of the parameter becomes the block, a copy); returns the
    specs. A device mesh, or a model axis of 1, shards nothing."""
    import torch

    if not mesh.distributed or mesh.shape[MODEL_AXIS] == 1:
        return {}
    specs = param_specs(model, mesh.shape[MODEL_AXIS])
    params = dict(model.named_parameters())
    with torch.no_grad():
        for name, dim in specs.items():
            p = params[name]
            p.data = mesh.block(p.data, dim, MODEL_AXIS).clone()
    return specs


def shard_state_like_params(state, mesh, specs: Dict[str, int], names) -> None:
    """Cut a full optimizer state (``state_dict()["state"]``, keyed by the
    position of each trained parameter in ``names``) down to this rank's
    blocks of the sharded parameters' moments, in place."""
    for index, moments in state.items():
        dim = specs.get(names[int(index)])
        if dim is None:
            continue
        for key, value in moments.items():
            if hasattr(value, "ndim") and value.ndim > dim and key != "step":
                moments[key] = mesh.block(value, dim, MODEL_AXIS).clone()


def full_tensor(tensor, mesh, dim: Optional[int]):
    """The whole of a sharded tensor (its blocks joined over the model
    axis); a tensor kept whole as it is."""
    if dim is None or not mesh.distributed:
        return tensor
    return mesh.all_gather(tensor.detach().contiguous(), dim, MODEL_AXIS)


def gather_params(model, mesh, specs: Dict[str, int]) -> Dict[str, object]:
    """{name: the whole parameter} for every sharded parameter, joined so
    that gradients reach each rank's block (``gather_blocks``); the
    argument to ``torch.func.functional_call``."""
    params = dict(model.named_parameters())
    return {name: gather_blocks(params[name], mesh, dim, MODEL_AXIS)
            for name, dim in specs.items()}
