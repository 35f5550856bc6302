"""Tracing and step timing: the port of ``vct/utils/profiling.py``.

The reference's observability is two wall-clock prints and a per-epoch
history JSON (``lrcn/mamba.py:412-420`` -> ``training_history.json``); the
trainer emits both. Beside them, ``device_trace`` records a
``torch.profiler`` trace (TensorBoard's and Chrome's trace format) and
``StepTimer`` times steps between host syncs.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import time
from typing import Dict, List, Optional

import torch

__all__ = ["device_trace", "StepTimer", "write_history"]


@contextlib.contextmanager
def device_trace(log_dir: Optional[str], device="cpu"):
    """``torch.profiler`` over the block: CPU activity, plus CUDA activity
    when ``device`` is a CUDA device. On exit one Chrome trace,
    ``<host>_<pid>.<ns>.pt.trace.json``, is written into ``log_dir``. A no-op
    when ``log_dir`` is empty."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield


class StepTimer:
    """Step timing that is truthful under asynchronous launches.

    A step returns once its kernels are queued, so the only observable wall
    time runs between host syncs. ``start()`` opens a span (a no-op if one
    is open), ``step()`` counts a launched step, and ``sync()``, called just
    after a value reached the host (``.item()``, the epoch's stacked fetch),
    closes the span and records its time over its steps, once a step. With a
    sync every step (``log_every=1``) that is each step's wall time; with
    one fetch an epoch, the epoch's mean step time. Launch latency alone is
    never recorded.
    """

    def __init__(self):
        self.times: List[float] = []
        self._t0: Optional[float] = None
        self._steps: int = 0

    def start(self):
        if self._t0 is None:
            self._t0 = time.perf_counter()

    def step(self):
        self._steps += 1

    def sync(self):
        """Close the span at a host sync; attribute its time per step."""
        if self._t0 is not None and self._steps:
            per_step = (time.perf_counter() - self._t0) / self._steps
            self.times.extend([per_step] * self._steps)
        self._t0 = None
        self._steps = 0

    @property
    def last_ms(self) -> float:
        return self.times[-1] * 1e3 if self.times else 0.0

    def summary(self) -> Dict[str, float]:
        if not self.times:
            return {"steps": 0}
        ts = sorted(self.times)
        n = len(ts)
        return {
            "steps": n,
            "mean_ms": sum(ts) / n * 1e3,
            "p50_ms": ts[n // 2] * 1e3,
            # nearest-rank percentile: ceil(0.9 n) - 1 (int(0.9 n) is the max for small n)
            "p90_ms": ts[max(math.ceil(0.9 * n) - 1, 0)] * 1e3,
            "max_ms": ts[-1] * 1e3,
        }


def write_history(path: str, history: dict) -> None:
    """The per-epoch training history JSON (``training_history.json``'s shape)."""
    if os.path.dirname(path):
        os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(history, f, indent=2)
