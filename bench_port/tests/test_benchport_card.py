"""On the card: a short run of each real cell through the command the
driver runs, its result line as the contract has it. Skips without a card.

    python -m pytest --noconftest bench_port/tests -m cuda -q
"""

from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch
from common import REPO

CELLS = json.loads((REPO / "BENCHMARK.json").read_text())["workloads"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", [c["name"] for c in CELLS])
def test_cell_on_the_card(card, cell, trace):
    out = subprocess.run([sys.executable, "bench_port/run.py", "--workload", cell, "--seed",
                          str(2 ** 32 + 17), "--seconds", "2", "--trace", str(trace)],
                         cwd=REPO, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True, out.stderr[-2000:]
    assert result["device"]["platform"] == "gpu"
    assert result["metrics"]
    if trace:
        assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [c["name"] for c in CELLS])
def test_program_with_tf32_is_not_correct(card, monkeypatch, cell):
    """The control at the cell's own size, in a whole run: the program with
    its TF32 path on (torch's flags, inside ``classify_videos``) where the
    configuration states float32."""
    import time

    from bench_port import run
    from bench_port.reference.precision import tf32
    from vct_torch.serve import deployment

    classify = deployment.classify_videos

    def control(*args, **kw):
        with tf32(True):
            return classify(*args, **kw)

    monkeypatch.setattr(deployment, "classify_videos", control)
    result, lines = run.run_cell(cell, 2 ** 32 + 29, 5.0, False, torch.device("cuda", 0),
                                 time.perf_counter())
    print(cell, lines)
    assert result["correct"] is False, lines
