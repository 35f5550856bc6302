"""The readings that a cell's limits are set from, on the cell's own sizes.

    python3 bench_port/tools/readings.py --workload <cell> --seeds 1,2,3 --what sound,control

For each seed, from the seed's inputs and weights as a run makes them, the
numbers the cell's comparison makes, from each run that ``--what`` names:
the sound program (the lower readings), the control and the other runs
that the cell's traffic driver offers (its ``readings`` function, found
through the cell like the driver of a run; ``drivers/serve_backlog.py``
lists its runs). Benchmark runs do not run this; its readings set the
limits in ``workloads/<cell>.json`` (PERF.md keeps them). Prints one JSON
line a seed; needs the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from bench_port.core.spec import BENCH_DIR, load_cell  # noqa: E402


class _Setup:
    """What a driver's set-up functions ask of a run."""

    def __init__(self, seed: int, device):
        self.seed, self.device = seed, device


def readings(cell, seed: int, what, device) -> dict:
    return cell.driver().readings(cell, _Setup(seed, device), what)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--what", default="sound,control")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--bench-dir", default=str(BENCH_DIR))
    args = parser.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = load_cell(args.workload, Path(args.bench_dir))
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        out = readings(cell, seed, args.what.split(","), device)
        print(json.dumps({"workload": args.workload, "seed": seed, **out,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
