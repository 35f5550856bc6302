"""Every kind of cell end to end at a tiny size on the CPU, with the
program's plain paths: the result line as the contract has it."""

from __future__ import annotations

import json

import pytest
from common import CELLS, run_tiny, tiny_copy

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_copy(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("trace", [False, True], ids=["timed", "traced"])
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_cell_prints_the_result_line(root, cell, trace):
    result, lines = run_tiny(root, cell, trace=trace)
    json.loads(json.dumps(result))
    assert list(result)[:5] == KEYS and list(result)[-1] == "checks"
    assert result["correct"] is True, lines
    assert result["failed"] == 0 and result["attempted"] > 0
    assert result["device"]["platform"] == "cpu" and result["device"]["count"] == 1
    assert [line.split(":")[0] for line in lines] == [f"check {k}" for k in result["checks"]]
    for check in result["checks"].values():
        assert check["value"] <= check["limit"]
    if trace:
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
        assert result["device"]["window_s"] > 0
        # No card: no device operation, so no device metric is written.
        assert result["device"]["busy_s"] == 0 and result["metrics"] == {}
    else:
        assert set(result["metrics"]) == {"setup_s", "serve_clips_per_s", "serve_p95_ms"}
        assert all(m["value"] > 0 for m in result["metrics"].values())


def test_same_seed_same_answers(root):
    """Inputs and weights come from the seed alone."""
    a, _ = run_tiny(root, "tiny_lstm_serve", seed=5)
    b, _ = run_tiny(root, "tiny_lstm_serve", seed=5)
    assert a["checks"] == b["checks"]


def test_whole_cycles_and_every_answer_compared(root):
    """The window runs whole cycles of the backlog (3 batches of 4 videos)."""
    result, _ = run_tiny(root, "tiny_mamba_serve")
    assert result["attempted"] % 12 == 0 and result["attempted"] >= 12
