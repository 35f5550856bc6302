"""The traced stretch of a run and what the per-layer metrics read from it.

A traced run (``--trace 1``) profiles a steady stretch of its window with
``torch.profiler``. Host ranges come from the benchmark alone: spans around
its own calls (``bp.copy``, ``bp.select``, ``bp.classify``) and
ranges that forward hooks on the model's modules open and close
(``bp.backbone``, ``bp.head``), named in the configuration's file. The
Chrome trace is written under the temporary directory, read back and
deleted.

A device operation (kernel, copy, set) belongs to a host range when the
host call that launched it ran inside that range on the same thread.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import sys
import tempfile
import time
from collections import defaultdict

import torch

__all__ = ["span", "ModuleRanges", "Stretch", "Trace", "View", "launch_counts"]

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
STRETCH = "bp.stretch"


def span(name: str, on: bool):
    """A host range named ``name`` in a traced run; nothing otherwise."""
    return torch.profiler.record_function(name) if on else contextlib.nullcontext()


class ModuleRanges:
    """Forward hooks that open range ``name`` as module ``first`` starts and
    close it as module ``last`` ends, for each name -> [first, last]."""

    def __init__(self, model: torch.nn.Module, ranges: dict):
        modules = dict(model.named_modules())
        self._handles, self._open = [], {}
        for name, (first, last) in ranges.items():
            for part in (first, last):
                if part not in modules:
                    raise KeyError(f"range {name}: the model has no module {part!r}")
            self._handles.append(modules[first].register_forward_pre_hook(self._opener(name)))
            self._handles.append(modules[last].register_forward_hook(self._closer(name)))

    def _opener(self, name):
        def hook(module, args):
            rf = torch.profiler.record_function(name)
            rf.__enter__()
            self._open[name] = rf
        return hook

    def _closer(self, name):
        def hook(module, args, output):
            rf = self._open.pop(name, None)
            if rf is not None:
                rf.__exit__(None, None, None)
        return hook

    def remove(self) -> None:
        for h in self._handles:
            h.remove()


def launch_counts() -> dict:
    """The program's kernel wrappers' ``.launches`` counters, by wrapper."""
    out = {}
    for mod_name, mod in list(sys.modules.items()):
        if not mod_name.startswith("vct_torch.ops.") or mod is None:
            continue
        for attr, fn in vars(mod).items():
            n = getattr(fn, "launches", None)
            if callable(fn) and isinstance(n, int):
                out[f"{mod_name.rsplit('.', 1)[1]}.{attr}"] = n
    return out


class Stretch:
    """Profile the work done inside the ``with`` block (synchronised at
    both ends); ``.trace`` holds what was read from it."""

    def __init__(self, device: torch.device):
        self.device = device
        self.trace = None
        self.host_s = 0.0

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __enter__(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._sync()
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.__enter__()
        self._range = torch.profiler.record_function(STRETCH)
        self._range.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._sync()
        self.host_s = time.perf_counter() - self._t0
        self._range.__exit__(None, None, None)
        self._prof.__exit__(*exc)
        if exc[0] is not None:
            return False
        fd, path = tempfile.mkstemp(suffix=".pt.trace.json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                self.trace = Trace(json.load(f))
        finally:
            os.unlink(path)
        return False


class Trace:
    """The stretch's events: device operations, host launches and ranges."""

    def __init__(self, chrome: dict):
        events = chrome["traceEvents"] if isinstance(chrome, dict) else chrome
        self.device_ops, launches, ranges, host_ops = [], {}, defaultdict(list), []
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = e.get("cat", "")
            ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
            args = e.get("args") or {}
            if cat in DEVICE_CATS:
                self.device_ops.append((ts, ts + dur, e["name"], cat, args.get("correlation")))
            elif cat in LAUNCH_CATS and "correlation" in args:
                launches[args["correlation"]] = (e.get("tid"), ts)
            elif cat == "user_annotation":
                ranges[e["name"]].append((ts, ts + dur, e.get("tid")))
            elif cat == "cpu_op":
                host_ops.append((ts, ts + dur, e["name"], e.get("tid")))
        if not ranges.get(STRETCH):
            raise ValueError("the trace holds no stretch range")
        self.t0, self.t1, self.main_tid = ranges[STRETCH][0]
        self.window_s = (self.t1 - self.t0) * 1e-6
        self.device_ops = sorted((op for op in self.device_ops if op[1] > self.t0 and op[0] < self.t1),
                                 key=lambda op: (op[0], op[1]))
        self._launches = launches
        self._ranges = {n: sorted(r) for n, r in ranges.items()}
        self._host = sorted(h for h in host_ops if h[3] == self.main_tid)

    # --- attribution ---------------------------------------------------
    def in_range(self, op, name: str) -> bool:
        launch = self._launches.get(op[4])
        spans = self._ranges.get(name)
        if launch is None or not spans:
            return False
        tid, ts = launch
        i = bisect.bisect_right(spans, (ts, float("inf"), None)) - 1
        while i >= 0:  # one thread's ranges of one name never overlap
            start, end, rtid = spans[i]
            if rtid == tid:
                return start <= ts <= end
            i -= 1
        return False

    def kernels(self, fragments=None, range_name=None) -> list:
        """Kernels whose name holds any of ``fragments`` (all, where None),
        launched inside ``range_name`` (anywhere, where None)."""
        out = []
        for op in self.device_ops:
            if op[3] != "kernel":
                continue
            if fragments is not None and not any(f in op[2] for f in fragments):
                continue
            if range_name is not None and not self.in_range(op, range_name):
                continue
            out.append(op)
        return out

    @staticmethod
    def seconds(ops) -> float:
        return sum(op[1] - op[0] for op in ops) * 1e-6

    # --- the device's timeline -------------------------------------------
    def _union(self) -> list:
        merged = []
        for start, end, *_ in self.device_ops:
            start, end = max(start, self.t0), min(end, self.t1)
            if merged and start <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], end)
            else:
                merged.append([start, end])
        return merged

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self._union()) * 1e-6

    def top_ops(self, n: int = 10) -> list:
        total = defaultdict(float)
        for start, end, name, _, _ in self.device_ops:
            total[name[:160]] += (end - start) * 1e-6
        return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:n]]

    def _host_doing(self, t: float) -> str:
        """The innermost benchmark range and host operator on the main
        thread at time ``t``."""
        names = []
        for name, spans in self._ranges.items():
            if name == STRETCH:
                continue
            if any(s <= t <= e and tid == self.main_tid for s, e, tid in spans):
                names.append(name)
        i = bisect.bisect_right(self._host, (t, float("inf"), "", None)) - 1
        op = None
        for j in range(i, max(i - 64, -1), -1):  # the latest-starting op that holds t
            s, e, name, _ = self._host[j]
            if s <= t <= e:
                op = name
                break
        label = "+".join(sorted(names)) or "outside the benchmark's ranges"
        return f"{label}: {op}" if op else label

    def idle_gaps(self, n: int = 10) -> list:
        """Idle device time summed by what the host was doing as each gap
        began, the largest ``n``."""
        total = defaultdict(float)
        edge = self.t0
        for start, end in self._union() + [[self.t1, self.t1]]:
            if start > edge:
                total[self._host_doing(edge)] += (start - edge) * 1e-6
            edge = max(edge, end)
        return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:n]]


class View:
    """What a per-layer metric's reader sees of a traced run: the trace of
    the stretch, the shape of each work unit in it (``{"batch": B, "L":
    frames}`` for a served batch), the clips and seconds of the rest of the
    window (not profiled), and the cell's configuration and traffic files."""

    def __init__(self, trace: Trace, shapes: list, cfg: dict, traffic: dict,
                 untraced_clips: int = 0, untraced_s: float = 0.0):
        self.trace, self.shapes = trace, shapes
        self.units = len(shapes)
        self.untraced_clips, self.untraced_s = untraced_clips, untraced_s
        self.cfg, self.traffic = cfg, traffic

    def ms_per_unit(self, ops) -> float | None:
        """Device ms a unit of ``ops``; None where there are none."""
        return Trace.seconds(ops) * 1e3 / self.units if ops and self.units else None

    def roofline(self, ops, least_s: float) -> float | None:
        """``least_s``, the least time of a layer's work over the whole
        stretch, over the device time of its kernels ``ops``, in percent;
        None where there are none."""
        busy = Trace.seconds(ops)
        return 100.0 * least_s / busy if ops and busy > 0 else None

    def flops_share(self, flops_per_clip: float, peak_per_s: float) -> float | None:
        """Counted operations of the window's clips outside the profiled
        stretch (the profiler slows the host) over their seconds, as a share
        of ``peak_per_s``, in percent; None where no device operation ran (a
        run without a card) or the window had no time outside."""
        if self.trace.busy_s <= 0 or self.untraced_s <= 0:
            return None
        return 100.0 * self.untraced_clips * flops_per_clip / (self.untraced_s * peak_per_s)
