"""Multi-process helpers: the port of ``vct/parallel/multihost.py``.

``vct`` wires one process per host into one device set with
``jax.distributed.initialize``. Torch's idiom is one process per rank (a
card, or a CPU worker), started by ``torchrun`` or by
``vct_torch.tools.dryrun``, and joined by ``torch.distributed``: NCCL for
CUDA ranks, gloo for CPU ranks (or named by the caller for ranks that share
one card, which NCCL refuses). The rest of the port is process-count
agnostic through these helpers: ``make_mesh`` spans the world's ranks,
``process_shard`` gives each process its slice of a dataset (a copy of
``vct``'s: the same indices for every ``(n, index, count)``) and
``is_primary`` gates the checkpoint and log writes.
"""

from __future__ import annotations

import os
from datetime import timedelta
from typing import Optional

import numpy as np

__all__ = ["initialize", "process_shard", "is_primary", "barrier", "shutdown",
           "local_device", "process_index", "process_count", "primary_first"]

# The rank's device, set by ``initialize``.
_LOCAL = {"device": None}


def _dist():
    import torch.distributed as dist

    return dist


def _env_int(name: str, default: int) -> int:
    value = os.environ.get(name)
    return default if value in (None, "") else int(value)


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    initialization_timeout: Optional[int] = None,
    backend: Optional[str] = None,
    device=None,
) -> None:
    """``torch.distributed.init_process_group`` with ``torchrun``'s defaults.

    Unset arguments come from the environment ``torchrun`` sets: ``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK`` and ``MASTER_ADDR`` / ``MASTER_PORT``
    (``coordinator_address`` is ``host:port``, as in ``vct``). The rank's
    device is ``device`` if given, else the card ``cuda:LOCAL_RANK`` (which
    raises without CUDA: pass ``device="cpu"`` for a CPU rank). The backend
    is NCCL for a CUDA device and gloo for the CPU, unless ``backend`` names
    one (gloo for ranks that share one card). A failed init raises; it is
    never retried on another backend."""
    import torch

    from vct_torch.device import resolve_device

    dist = _dist()
    rank = process_id if process_id is not None else _env_int("RANK", 0)
    world = num_processes if num_processes is not None else _env_int("WORLD_SIZE", 1)
    local_rank = _env_int("LOCAL_RANK", rank)
    if coordinator_address is None:
        host = os.environ.get("MASTER_ADDR", "localhost")
        port = os.environ.get("MASTER_PORT")
        if port is None:
            raise ValueError("no coordinator: pass coordinator_address='host:port' or set "
                             "MASTER_ADDR / MASTER_PORT (torchrun does)")
        coordinator_address = f"{host}:{port}"
    dev = resolve_device(device if device is not None else f"cuda:{local_rank}")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kwargs = {}
    if initialization_timeout is not None:
        kwargs["timeout"] = timedelta(seconds=initialization_timeout)
    if backend == "nccl":
        kwargs["device_id"] = dev
    dist.init_process_group(backend=backend, init_method=f"tcp://{coordinator_address}",
                            world_size=world, rank=rank, **kwargs)
    _LOCAL["device"] = dev


def local_device():
    """The device ``initialize`` gave this rank (None before it)."""
    return _LOCAL["device"]


def _rank() -> int:
    dist = _dist()
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def _world() -> int:
    dist = _dist()
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


process_index = _rank  # this process's rank (0 without a process group)
process_count = _world  # the world's size (1 without a process group)


def process_shard(n: int, process_index: Optional[int] = None,
                  process_count: Optional[int] = None) -> np.ndarray:
    """Indices of the dataset slice owned by this process: contiguous split
    with the remainder spread over the first processes."""
    pi = _rank() if process_index is None else process_index
    pc = _world() if process_count is None else process_count
    base = n // pc
    rem = n % pc
    start = pi * base + min(pi, rem)
    count = base + (1 if pi < rem else 0)
    return np.arange(start, start + count)


def is_primary() -> bool:
    """True on the process that should write checkpoints and logs: rank 0,
    or the only process when no process group is up."""
    return _rank() == 0


def barrier(tag: str = "") -> None:
    """Every rank waits here for every other (a no-op without a process
    group). ``tag`` names the barrier in a hang's traceback only. Under NCCL
    the barrier is an all-reduce on the rank's card, so it also orders the
    card's queued work."""
    dist = _dist()
    if not (dist.is_available() and dist.is_initialized()) or dist.get_world_size() == 1:
        return
    dev = local_device()
    if dist.get_backend() == "nccl" and dev is not None:
        dist.barrier(device_ids=[dev.index])
    else:
        dist.barrier()


def primary_first(fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` on the primary, then, past a barrier, on the
    other ranks: a step that builds a file cache the others then read
    (decode and cache a dataset) runs once."""
    if is_primary():
        out = fn(*args, **kwargs)
        barrier("primary first")
        return out
    barrier("primary first")
    return fn(*args, **kwargs)


def shutdown() -> None:
    """Leave the process group (every rank first meets at a barrier, so no
    rank tears its connections down while another still uses them)."""
    dist = _dist()
    if dist.is_available() and dist.is_initialized():
        barrier("shutdown")
        dist.destroy_process_group()
    _LOCAL["device"] = None
