"""The (data, model) mesh and its batch placement: the port of
``vct/parallel/mesh.py``.

``vct`` builds one ``jax.sharding.Mesh`` that a single program spans and
lets XLA insert the collectives. Here a ``Mesh`` is one of two things:

* a grid of **ranks** (``torch.distributed`` is up): rank ``r`` sits at
  ``(r // model, r % model)``, holds its own device, and reaches the ranks
  of its grid row (the ``model`` axis) and grid column (the ``data`` axis)
  through process groups. Training runs so (``vct_torch.train.engine``),
  one process per rank;
* a grid of **devices** in one process (no process group, or devices named
  by the caller): serving runs so, one model replica a data row
  (``vct_torch.serve.deployment.classify_videos``).

The collectives are sums (``all_reduce``), and a gather is the sum of
zero-padded blocks, so every one of them runs on gloo's CUDA tensors too
(gloo takes CUDA tensors only for ``broadcast`` and ``all_reduce``): two
ranks may share one card.
"""

from __future__ import annotations

import contextlib
import copy
import threading
from typing import List, Optional, Sequence

import numpy as np

__all__ = [
    "Mesh",
    "gather_blocks",
    "sum_over",
    "make_mesh",
    "batch_sharding",
    "replicated",
    "put_sharded",
    "shard_batch",
    "host_to_device",
    "activate_mesh",
    "ambient_mesh",
    "visible_devices",
]

DATA_AXIS = "data"
MODEL_AXIS = "model"

_ACTIVE = threading.local()


@contextlib.contextmanager
def activate_mesh(mesh):
    """Enter ``mesh`` for the enclosed computation: ``ambient_mesh`` returns
    it until the block ends, then the mesh entered before (nesting as in
    ``vct``)."""
    prev = getattr(_ACTIVE, "mesh", None)
    _ACTIVE.mesh = mesh
    try:
        yield mesh
    finally:
        _ACTIVE.mesh = prev


def ambient_mesh():
    """The mesh entered with ``activate_mesh`` (None outside any). The
    models read it where a layer's work depends on the mesh: the LRCN's
    ``seq_shard``, dropout's global masks, the scratch CNN's batch
    statistics. Forward passes run on the calling thread, so a thread-local
    is the right carrier."""
    return getattr(_ACTIVE, "mesh", None)


def visible_devices(device) -> list:
    """Every device of ``device``'s type this process sees: each card for
    CUDA, the one CPU device for the CPU."""
    import torch

    device = torch.device(device)
    if device.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [device]


class Mesh:
    """A (data, model) grid of ranks (``distributed``) or of devices."""

    axis_names = (DATA_AXIS, MODEL_AXIS)

    def __init__(self, grid: np.ndarray, distributed: bool, device=None):
        self.grid = grid  # (data, model): ranks, or torch.devices
        self.distributed = distributed
        self.shape = {DATA_AXIS: grid.shape[0], MODEL_AXIS: grid.shape[1]}
        self.size = int(grid.size)
        self.device = device if device is not None else grid.flat[0]
        self.groups = {DATA_AXIS: None, MODEL_AXIS: None}
        self.data_index, self.model_index = 0, 0
        if distributed:
            self._make_groups()

    def _make_groups(self) -> None:
        import torch.distributed as dist

        rank = dist.get_rank()
        self.data_index, self.model_index = (int(i[0]) for i in np.nonzero(self.grid == rank))
        # Every rank creates every group, in the same order (new_group's rule).
        for col in range(self.shape[MODEL_AXIS]):
            ranks = [int(r) for r in self.grid[:, col]]
            group = dist.new_group(ranks) if len(ranks) > 1 else None
            if col == self.model_index:
                self.groups[DATA_AXIS] = group
        for row in range(self.shape[DATA_AXIS]):
            ranks = [int(r) for r in self.grid[row, :]]
            group = dist.new_group(ranks) if len(ranks) > 1 else None
            if row == self.data_index:
                self.groups[MODEL_AXIS] = group

    def __repr__(self) -> str:
        kind = "ranks" if self.distributed else "devices"
        return f"Mesh({self.shape}, {kind})"

    # ------------------------------------------------------------------
    # Collectives of a rank mesh; each is the identity along an axis of size 1.
    def all_reduce(self, tensor, axes=(DATA_AXIS, MODEL_AXIS)):
        """Sum ``tensor`` in place over the ranks that differ along ``axes``
        (a name or a tuple of names); returns it."""
        import torch.distributed as dist

        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        if not self.distributed:
            return tensor
        if set(axes) == {DATA_AXIS, MODEL_AXIS}:
            if self.size > 1:
                dist.all_reduce(tensor)  # a rank mesh spans the whole world
            return tensor
        for axis in axes:
            if self.groups[axis] is not None:
                dist.all_reduce(tensor, group=self.groups[axis])
        return tensor

    def all_gather(self, tensor, dim: int, axis: str):
        """The blocks of ``axis``'s ranks along ``dim``, in rank order: each
        rank's block placed in zeros and the whole summed (exact: every
        element is one block's value plus zeros)."""
        import torch

        n = self.shape[axis]
        if not self.distributed or n == 1:
            return tensor
        index = self.data_index if axis == DATA_AXIS else self.model_index
        size = tensor.shape[dim]
        shape = list(tensor.shape)
        shape[dim] = size * n
        out = torch.zeros(shape, dtype=tensor.dtype, device=tensor.device)
        out.narrow(dim, index * size, size).copy_(tensor)
        return self.all_reduce(out, axis)

    def block(self, tensor, dim: int, axis: str):
        """This rank's block of ``tensor`` along ``dim`` (of ``axis``'s ranks)."""
        n = self.shape[axis]
        if n == 1:
            return tensor
        index = self.data_index if axis == DATA_AXIS else self.model_index
        size = tensor.shape[dim] // n
        return tensor.narrow(dim, index * size, size)


def _arrange(n: int, data: int, model: int):
    if data == -1:
        if n % model:
            raise ValueError(f"{n} devices not divisible by model={model}")
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} devices")
    return data, model


def make_mesh(devices: Optional[Sequence] = None, data: int = -1, model: int = 1) -> Mesh:
    """Create a (data, model) mesh; ``data=-1`` absorbs the remaining ranks
    or devices. With ``devices`` None and a process group up, the mesh spans
    the world's ranks (this rank's device from
    ``multihost.initialize``); otherwise it spans ``devices`` (default:
    every visible card, raising without one as ``resolve_device`` does) in
    this process."""
    import torch
    import torch.distributed as dist

    from vct_torch.device import resolve_device
    from vct_torch.parallel import multihost

    if devices is None and dist.is_available() and dist.is_initialized():
        n = dist.get_world_size()
        data, model = _arrange(n, data, model)
        device = multihost.local_device()
        if device is None:
            raise ValueError("the process group was not started by "
                             "vct_torch.parallel.multihost.initialize: its device is unknown")
        return Mesh(np.arange(n).reshape(data, model), distributed=True, device=device)
    if devices is None:
        devices = visible_devices(resolve_device(None))
    devices = [torch.device(d) for d in devices]
    data, model = _arrange(len(devices), data, model)
    grid = np.empty((data, model), dtype=object)
    for i, d in enumerate(devices):
        grid[i // model, i % model] = d
    return Mesh(grid, distributed=False)


class _Sharding:
    def __init__(self, mesh: Mesh, batch: bool):
        self.mesh = mesh
        self.batch = batch

    def __repr__(self) -> str:
        return f"{'batch' if self.batch else 'replicated'} over {self.mesh}"


def batch_sharding(mesh: Mesh) -> _Sharding:
    """Batch-leading arrays shard over the data axis."""
    return _Sharding(mesh, batch=True)


def replicated(mesh: Mesh) -> _Sharding:
    return _Sharding(mesh, batch=False)


def _to_device(x, device):
    import torch

    if isinstance(x, torch.nn.Module):
        return x.to(device)
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.as_tensor(np.ascontiguousarray(x)).to(device)


def put_sharded(x, sharding: _Sharding):
    """Place one batch-leading array under ``sharding``.

    A rank mesh: ``x`` is this process's own rows (``vct``'s
    ``make_array_from_process_local_data`` branch); they go to the rank's
    device. A device mesh: batch sharding splits ``x``'s rows into one
    equal slice a data row, each on its row's first device (a list of
    tensors, in row order); replication gives one copy a data row."""
    mesh = sharding.mesh
    if mesh.distributed:
        return _to_device(x, mesh.device)
    rows = [row[0] for row in mesh.grid]
    if not sharding.batch:
        return [_to_device(x, d) for d in rows]
    n = len(x)
    if n % len(rows):
        raise ValueError(f"batch of {n} rows does not split over data={len(rows)}")
    k = n // len(rows)
    return [_to_device(x[i * k:(i + 1) * k], d) for i, d in enumerate(rows)]


def shard_batch(batch, mesh: Mesh):
    """``put_sharded`` of each array of a tuple, list or dict, over data."""
    s = batch_sharding(mesh)
    if isinstance(batch, dict):
        return {k: put_sharded(v, s) for k, v in batch.items()}
    return type(batch)(put_sharded(v, s) for v in batch)


def host_to_device(tree, mesh: Optional[Mesh] = None):
    """Replicated placement of a module, a tensor or a tuple, list or dict
    of them. No mesh: on the card. A rank mesh: on the rank's device. A
    device mesh: one replica a data row, in row order, the first the object
    itself where it already lives on that row's device (modules are copied
    for every other row)."""
    import torch

    from vct_torch.device import resolve_device

    def place(x, device, copy_module: bool):
        if isinstance(x, dict):
            return {k: place(v, device, copy_module) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(place(v, device, copy_module) for v in x)
        if isinstance(x, torch.nn.Module) and copy_module:
            return copy.deepcopy(x).to(device)
        return _to_device(x, device)

    if mesh is None:
        return place(tree, resolve_device(None), False)
    if mesh.distributed:
        return place(tree, mesh.device, False)
    replicas: List = []
    for i, row in enumerate(mesh.grid):
        replicas.append(place(tree, row[0], copy_module=i > 0 or not _lives_on(tree, row[0])))
    return replicas


def _lives_on(tree, device) -> bool:
    import torch

    if isinstance(tree, torch.nn.Module):
        p = next(tree.parameters(), None)
        return p is None or _same_device(p.device, device)
    return True


def _same_device(a, b) -> bool:
    """``cuda`` and ``cuda:<current>`` are the same card."""
    import torch

    a, b = torch.device(a), torch.device(b)
    if a.type != b.type:
        return False
    if a.type != "cuda":
        return True
    cur = torch.cuda.current_device()
    return (a.index if a.index is not None else cur) == (b.index if b.index is not None else cur)


def _autograd_collectives():
    import torch

    class GatherBlocks(torch.autograd.Function):
        """Forward: the blocks of an axis's ranks joined along ``dim``.
        Backward: this rank's block of the incoming gradient. Right where
        every rank of the axis computes the same thing from the joined
        tensor (the model axis: the ranks of a data row see the same rows),
        so each one's gradient of the whole is the same."""

        @staticmethod
        def forward(ctx, tensor, mesh, dim, axis):
            ctx.mesh, ctx.dim, ctx.axis = mesh, dim, axis
            return mesh.all_gather(tensor.detach(), dim, axis)

        @staticmethod
        def backward(ctx, grad):
            return ctx.mesh.block(grad, ctx.dim, ctx.axis).contiguous(), None, None, None

    class SumOver(torch.autograd.Function):
        """The sum of a tensor over an axis's ranks, whose gradient is the
        sum of the ranks' gradients (each rank's loss reads the sum)."""

        @staticmethod
        def forward(ctx, tensor, mesh, axis):
            ctx.mesh, ctx.axis = mesh, axis
            return mesh.all_reduce(tensor.detach().clone(), axis)

        @staticmethod
        def backward(ctx, grad):
            return ctx.mesh.all_reduce(grad.contiguous().clone(), ctx.axis), None, None

    return GatherBlocks, SumOver


_FUNCTIONS = {}


def _function(name: str):
    if not _FUNCTIONS:
        _FUNCTIONS["gather"], _FUNCTIONS["sum"] = _autograd_collectives()
    return _FUNCTIONS[name]


def gather_blocks(tensor, mesh: Mesh, dim: int, axis: str = MODEL_AXIS):
    """``Mesh.all_gather`` that passes gradients back: each rank takes its
    block of the gradient of the joined tensor (see ``GatherBlocks``)."""
    if not mesh.distributed or mesh.shape[axis] == 1:
        return tensor
    return _function("gather").apply(tensor, mesh, dim, axis)


def sum_over(tensor, mesh: Mesh, axis: str = DATA_AXIS):
    """``Mesh.all_reduce`` out of place, with the gradient of a sum that
    every rank's loss reads: the ranks' gradients summed."""
    if not mesh.distributed or mesh.shape[axis] == 1:
        return tensor
    return _function("sum").apply(tensor, mesh, axis)
