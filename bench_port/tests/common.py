"""Tiny cells for the benchmark's CPU tests, in a copy of the benchmark.

Run the tests from the repository's root, without the root conftest (which
sets JAX up for the JAX package's tests):

    python -m pytest --noconftest bench_port/tests -q

The copy holds ``BENCHMARK.json`` and ``bench_port/`` with two tiny cells
added as files (resnet50 at 32 x 32 frames, T = 4, batches of 4), one of
each head the real cells have; the real cells' files are left as they are.
"""

from __future__ import annotations

import json
import shutil
import sys
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

CONTENT = {"run": [1, 3], "noisy_share": 0.5, "noise": 8}
RANGES = {"bp.backbone": ["cnn_backbone", "cnn_backbone"], "bp.head": ["adapt", "head"]}
BASE = {"model_family": "lrcn", "cnn_backbone": "resnet50", "mult_factor": 4, "rnn_out": "all",
        "bidirectional": False, "classif_mode": "multiclass", "use_adapt_dsl": False,
        "compute_dtype": "float32", "scan_impl": "pallas", "dropout": 0.25}
CONFIGS = {
    "tiny_mamba": dict(BASE, num_classes=4, rnn_type="mamba", rnn_input_size=8, rnn_layer=2,
                       hidden_size=None),
    "tiny_lstm": dict(BASE, num_classes=5, rnn_type="lstm", rnn_input_size=16, rnn_layer=2,
                      hidden_size=8),
}
# UCF101's published clip lengths at one frame a second: 1 to 28 frames,
# buckets of 4 to 32 frames at T = 4.
LENGTHS = {"min_s": 1.06, "mean_s": 7.21, "max_s": 71.04, "fps": 1}
TRAFFIC = {
    "backlog_tiny": {"kind": "serve_backlog", "lengths": LENGTHS, "batch": 4,
                     "distinct_batches": 3, "sampling": "sad", "content": CONTENT,
                     "warmup_cycles": 1, "trace_from_cycle": 1, "trace_cycles": 1},
}
# The tiny cells' limit, from CPU readings (``tools/readings.py --device cpu
# --what sound,ref_tf32,ref_bf16_head``) on seeds 7, 8, 9 and 2**31 + 11:
# sound runs read logp_rel 0.0026-0.0072, the reference at TF32 in the
# program's place 1.89-11.4, with its head alone in bfloat16 26.5-151.
SERVE_LIMITS = {"logp_rel": 0.3}
CONTROL_SEEDS = (8, 9)
CELLS = {
    "tiny_mamba_serve": ("tiny_mamba", "backlog_tiny", SERVE_LIMITS),
    "tiny_lstm_serve": ("tiny_lstm", "backlog_tiny", SERVE_LIMITS),
}


def write_json(path: Path, obj) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(obj, indent=1))


# A cell of each kind whose metrics a new cell of that kind reports.
TWINS = {"serve_backlog": "mamba_serve_sad"}


def add_cell(root: Path, name: str, config: str, traffic: str, limits: dict) -> None:
    """Add the cell ``name`` to the copy at ``root``: its own file and its
    entries in BENCHMARK.json (the metrics of its kind list it)."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    kind = json.loads((root / "bench_port" / "traffic" / f"{traffic}.json").read_text())["kind"]
    bench["workloads"].append({"name": name, "config": config, "traffic": traffic, "chips": 1,
                               "why": "a tiny cell for the CPU tests"})
    for metric in bench["end_to_end"] + bench["per_layer"]:
        if TWINS[kind] in metric.get("workloads", []):
            metric["workloads"].append(name)
    write_json(root / "BENCHMARK.json", bench)
    write_json(root / "bench_port" / "workloads" / f"{name}.json",
               {"config": config, "traffic": traffic, "limits": limits})


def tiny_copy(tmp: Path) -> Path:
    """A copy of the benchmark with the tiny configurations, traffic mixes
    and cells added; returns its root."""
    root = tmp / "checkout"
    shutil.copytree(REPO / "bench_port", root / "bench_port",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    for name, model in CONFIGS.items():
        write_json(root / "bench_port" / "configs" / f"{name}.json",
                   {"source": "a test", "model": model, "sequence_length": 4,
                    "frame": [32, 32, 3], "ranges": RANGES, "reduced": []})
    for name, traffic in TRAFFIC.items():
        write_json(root / "bench_port" / "traffic" / f"{name}.json", traffic)
    for name, (config, traffic, limits) in CELLS.items():
        add_cell(root, name, config, traffic, limits)
    return root


def run_tiny(root: Path, cell: str, seed: int = 2 ** 31 + 11, trace: bool = False,
             seconds: float = 0.5):
    """Run a cell of the copy on the CPU, past the harness's look for a card."""
    from bench_port import run

    torch.manual_seed(0)
    return run.run_cell(cell, seed, seconds, trace, torch.device("cpu"), time.perf_counter(),
                        bench_dir=root / "bench_port")
