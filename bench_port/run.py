"""The benchmark of vct_torch on an NVIDIA H100: one cell a run.

    python3 bench_port/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell's configuration, traffic mix and limits come from their files
(``core/spec.py``), the inputs and weights from ``--seed``. The run sets up
(model, data, warm-up: ``setup_s``), measures for ``--seconds`` and
compares what the window produced with the plain reference
(``reference/``). With ``--trace 0`` the result holds the cell's
end-to-end metrics; with ``--trace 1`` a stretch of the window is profiled
and the result holds its per-layer metrics (``metrics/<name>.py``), the
device's busy and traced seconds and a breakdown.

The last line of standard output is the result, one JSON object; the last
lines of standard error are the numbers compared, each beside its limit.
Exits 2 without a result where the card is missing, 3 where a forbidden
module (JAX, or the JAX package ``vct``) was loaded, and non-zero where the
program cannot be imported.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# Every build and kernel cache at a fixed path inside the checkout.
_CACHE = ROOT / ".bench_port_cache"
for _var, _sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("CUDA_CACHE_PATH", "cuda")):
    os.environ[_var] = str(_CACHE / _sub)
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

EXIT_NO_CARD = 2
EXIT_FORBIDDEN = 3


class Run:
    """One run of a cell, as its driver sees it."""

    def __init__(self, cell, seed: int, seconds: float, trace: bool, device: torch.device,
                 t_start: float, out=None):
        self.cell, self.seed, self.seconds, self.trace = cell, seed, seconds, trace
        self.device, self.t_start = device, t_start
        self.out = out or sys.stdout
        self.phases, self._last = {}, t_start

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def memory_peak(self) -> int:
        self.sync()
        return int(torch.cuda.max_memory_allocated(self.device)) if self.device.type == "cuda" else 0

    def free(self) -> None:
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def phase(self, name: str) -> None:
        """Mark the end of a set-up phase; the phases' seconds are noted
        when the window opens."""
        self.sync()
        now = time.perf_counter()
        self.phases[name] = now - self._last
        self._last = now
        if name == "warmup":
            self.note({"setup_phases_s": self.phases})

    def note(self, obj) -> None:
        """An earlier line of the output."""
        print(json.dumps(obj), file=self.out, flush=True)


def _card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def _check_reference(bench_dir: Path) -> None:
    """The reference reaches nothing of the program, of JAX or of ``vct``:
    by its import statements, and by what importing it loads."""
    from bench_port.core.guard import REFERENCE_FORBIDDEN, imports_forbidden, loaded_forbidden

    found = imports_forbidden(bench_dir / "reference")
    before = set(loaded_forbidden(REFERENCE_FORBIDDEN))
    import bench_port.reference.model  # noqa: F401

    found += sorted(set(loaded_forbidden(REFERENCE_FORBIDDEN)) - before)
    if found:
        raise RuntimeError(f"the reference reaches forbidden modules: {found}")


def run_cell(name: str, seed: int, seconds: float, trace: bool, device: torch.device,
             t_start: float, bench_dir: Path | None = None, out=None) -> tuple:
    """Run the cell; returns (result, check lines). Raises on a forbidden
    module."""
    from bench_port.core.guard import loaded_forbidden
    from bench_port.core.spec import BENCH_DIR, load_cell

    bench_dir = bench_dir or BENCH_DIR
    _check_reference(bench_dir)
    cell = load_cell(name, bench_dir)
    r = Run(cell, seed, seconds, trace, device, t_start, out)
    if device.type == "cuda":
        r.note({"card": _card_line(), "torch": torch.__version__, "cuda": torch.version.cuda})
    outcome = cell.driver().run(r)
    forbidden = loaded_forbidden()
    if forbidden:
        raise ImportError(f"forbidden modules loaded: {forbidden}")

    result = {"correct": None, "attempted": outcome["attempted"], "failed": outcome["failed"],
              "metrics": {}, "device": {
                  "platform": "gpu" if device.type == "cuda" else device.type,
                  "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
                  "count": cell.chips, "memory_peak_bytes": outcome["memory_peak_bytes"]}}
    if trace:
        view = outcome["view"]
        result["device"]["busy_s"] = view.trace.busy_s
        result["device"]["window_s"] = view.trace.window_s
        readers = cell.readers()
        for metric in cell.per_layer:
            value = readers[metric["name"]].read(view)
            if value is not None:
                result["metrics"][metric["name"]] = {"value": value, "unit": metric["unit"]}
        result["breakdown"] = {"device_ops": view.trace.top_ops(10),
                               "idle_gaps": view.trace.idle_gaps(10)}
    else:
        for metric in cell.end_to_end:
            result["metrics"][metric["name"]] = {"value": outcome["e2e"][metric["name"]],
                                                 "unit": metric["unit"]}
    checks = {k: {"value": v, "limit": lim} for k, (v, lim) in outcome["checks"].items()}
    result["correct"] = bool(outcome["failed"] == 0
                             and all(c["value"] <= c["limit"] for c in checks.values()))
    result["checks"] = checks
    lines = [f"check {k}: {c['value']!r} (limit {c['limit']!r})" for k, c in checks.items()]
    return result, lines


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available() or torch.cuda.device_count() < 1:
        print("no CUDA device: this benchmark measures the port on an NVIDIA GPU",
              file=sys.stderr)
        return EXIT_NO_CARD
    from bench_port.core.spec import BENCH_DIR, load_cell

    chips = load_cell(args.workload, BENCH_DIR).chips
    if torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} cards, found {torch.cuda.device_count()}",
              file=sys.stderr)
        return EXIT_NO_CARD
    try:
        result, lines = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                                 torch.device("cuda", 0), T_START)
    except ImportError as err:
        print(str(err), file=sys.stderr)
        return EXIT_FORBIDDEN
    print(json.dumps(result, default=_plain), flush=True)
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    return 0


def _plain(value):
    if isinstance(value, (np.integer,)):
        return int(value)
    if isinstance(value, (np.floating,)):
        return float(value)
    raise TypeError(f"not JSON: {type(value)}")


if __name__ == "__main__":
    sys.exit(main())
