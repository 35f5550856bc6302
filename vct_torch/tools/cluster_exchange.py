"""Time a step's exchange between the CTAs of a thread-block cluster.

    python3 -m vct_torch.tools.cluster_exchange

Builds ``vct_torch/tools/cluster_exchange.cu`` with nvcc (the flags of
``vct_torch/ops/_build.py``) into the build directory and runs it on the
card: for clusters of 2, 8 and 16 CTAs of 288 and 512 threads, the
microseconds a step of each way to hand one value a warp to every CTA and
wait for the others (the source's note lists them). Prints one JSON line
with the card's name and power limit. Needs nvcc and an NVIDIA GPU of
compute capability 9.0a.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

from vct_torch.ops import _build

_SOURCE = Path(__file__).resolve().with_suffix(".cu")


def main() -> int:
    out = _build.build_dir().parent / "tools"
    out.mkdir(parents=True, exist_ok=True)
    exe = out / "cluster_exchange"
    build = subprocess.run([_build._nvcc(), *_build._FLAGS[:4], str(_SOURCE), "-o", str(exe)],
                           capture_output=True, text=True)
    if build.returncode:
        print(build.stdout + build.stderr, file=sys.stderr)
        return 1
    run = subprocess.run([str(exe)], capture_output=True, text=True)
    if run.returncode:
        print(run.stdout + run.stderr, file=sys.stderr)
        return 1
    rows = [line.split() for line in run.stdout.splitlines()]
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(json.dumps({"us_per_step": [{"ctas": int(n), "threads": int(t), "mode": m,
                                       "us": float(us)} for n, t, m, us in rows],
                      "gpu": gpu}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
