"""A cell, found by name: its configuration, traffic mix and limits from
their own files, and the metrics ``BENCHMARK.json`` gives it.

    bench_port/workloads/<cell>.json    {"config", "traffic", "limits"}
    bench_port/configs/<config>.json    {"model": ModelConfig fields,
                                         "sequence_length", "frame", ...}
    bench_port/traffic/<traffic>.json   {"kind": <driver>, parameters ...}
    bench_port/drivers/<kind>.py        the driver of a kind of traffic: run(r),
                                        and readings(cell, r, what) for the limits
    bench_port/metrics/<metric>.py      one per-layer metric's reader
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path

__all__ = ["BENCH_DIR", "Cell", "load_cell", "load_module"]

BENCH_DIR = Path(__file__).resolve().parent.parent


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """A Python file of the benchmark, loaded by its path (metric names
    hold dots, so they are files, not importable modules)."""
    if not path.is_file():
        raise FileNotFoundError(f"no file {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    limits: dict
    chips: int = 1
    end_to_end: list = field(default_factory=list)  # BENCHMARK.json entries
    per_layer: list = field(default_factory=list)
    bench_dir: Path = BENCH_DIR

    def driver(self):
        kind = self.traffic["kind"]
        return load_module(self.bench_dir / "drivers" / f"{kind}.py", f"bench_port_driver_{kind}")

    def readers(self) -> dict:
        """metric name -> its reader module, for the cell's per-layer metrics."""
        return {m["name"]: load_module(self.bench_dir / "metrics" / f"{m['name']}.py",
                                       "bench_port_metric_" + m["name"].replace(".", "_"))
                for m in self.per_layer}


def load_cell(name: str, bench_dir: Path = BENCH_DIR) -> Cell:
    """The cell ``name`` with what ``BENCHMARK.json`` (beside ``bench_dir``)
    says of it. Raises where the files disagree."""
    bench = _json(bench_dir.parent / "BENCHMARK.json")
    entries = [w for w in bench["workloads"] if w["name"] == name]
    if len(entries) != 1:
        raise KeyError(f"BENCHMARK.json has no workload {name!r}")
    own = _json(bench_dir / "workloads" / f"{name}.json")
    if (own["config"], own["traffic"]) != (entries[0]["config"], entries[0]["traffic"]):
        raise ValueError(f"{name}: workloads/{name}.json names {own['config']}/{own['traffic']},"
                         f" BENCHMARK.json {entries[0]['config']}/{entries[0]['traffic']}")
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in reported)]
    return Cell(name=name, config=_json(bench_dir / "configs" / f"{own['config']}.json"),
                traffic=_json(bench_dir / "traffic" / f"{own['traffic']}.json"),
                limits=own["limits"], chips=entries[0]["chips"], end_to_end=e2e,
                per_layer=per_layer, bench_dir=bench_dir)
