"""A later change adds a configuration, a traffic mix, a cell and a
per-layer metric as new files and BENCHMARK.json entries, and runs them
without editing any file the benchmark already has."""

from __future__ import annotations

import hashlib
import json

from common import LENGTHS, RANGES, TRAFFIC, add_cell, run_tiny, tiny_copy, write_json

PROBE = '''"""A new per-layer metric: the batches in the traced stretch."""


def read(view):
    return float(view.units)
'''


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in (root / "bench_port").rglob("*") if p.is_file()}


def test_new_files_run_without_edits(tmp_path):
    root = tiny_copy(tmp_path)
    before = _digests(root)
    bp = root / "bench_port"
    write_json(bp / "configs" / "tiny_gru.json",
               {"source": "a test", "sequence_length": 3, "frame": [32, 32, 3],
                "ranges": RANGES, "reduced": [],
                "model": {"model_family": "lrcn", "cnn_backbone": "resnet50", "mult_factor": 4,
                          "rnn_out": "all", "bidirectional": False,
                          "classif_mode": "multiclass", "use_adapt_dsl": False,
                          "compute_dtype": "float32", "scan_impl": "pallas", "dropout": 0.0,
                          "num_classes": 3, "rnn_type": "gru", "rnn_input_size": 8,
                          "rnn_layer": 2, "hidden_size": 6}})
    write_json(bp / "traffic" / "backlog_long_tiny.json",
               dict(TRAFFIC["backlog_tiny"], lengths=dict(LENGTHS, fps=2), distinct_batches=2))
    (bp / "metrics" / "units_seen.serve.py").write_text(PROBE)
    add_cell(root, "tiny_gru_long", "tiny_gru", "backlog_long_tiny", {"logp_rel": 0.3})
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["per_layer"].append({"name": "units_seen.serve", "unit": "batches", "better": "higher",
                               "source": "program_counter", "layer": "serving glue",
                               "moves": "serve_clips_per_s", "workloads": ["tiny_gru_long"]})
    write_json(root / "BENCHMARK.json", bench)

    after = _digests(root)
    assert all(after[p] == d for p, d in before.items()), "an existing file changed"
    result, lines = run_tiny(root, "tiny_gru_long", trace=True)
    assert result["correct"] is True, lines
    assert result["metrics"] == {"units_seen.serve": {"value": 2.0, "unit": "batches"}}
    timed, _ = run_tiny(root, "tiny_gru_long")
    assert set(timed["metrics"]) == {"setup_s", "serve_clips_per_s", "serve_p95_ms"}
