"""The import guard: no run loads JAX or the JAX package ``vct`` (names
compared by their whole top level, so ``vct_torch`` passes), the reference
reaches nothing of the program, and a run without a card or without the
program exits without a result."""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
import types

import pytest
from common import REPO, run_tiny, tiny_copy

from bench_port.core.guard import FORBIDDEN, imports_forbidden, loaded_forbidden


def test_top_level_names_compared_whole():
    names = ["vct_torch", "vct_torch.ops", "vctx", "jaxtyping", "vct", "vct.models", "jax.numpy",
             "jaxlib", "flax.linen"]
    assert loaded_forbidden(FORBIDDEN, names) == sorted(
        ["vct", "vct.models", "jax.numpy", "jaxlib", "flax.linen"])


def test_reference_imports_nothing_forbidden(tmp_path):
    assert imports_forbidden(REPO / "bench_port" / "reference") == []
    (tmp_path / "bad.py").write_text("def f():\n    from vct_torch.ops import lstm\n")
    (tmp_path / "worse.py").write_text("import jax.numpy as jnp\n")
    assert imports_forbidden(tmp_path) == ["bad.py:2 vct_torch.ops", "worse.py:1 jax.numpy"]


def test_a_run_with_the_jax_package_loaded_has_no_result(tmp_path, monkeypatch):
    root = tiny_copy(tmp_path)
    monkeypatch.setitem(sys.modules, "vct", types.ModuleType("vct"))
    with pytest.raises(ImportError, match="vct"):
        run_tiny(root, "tiny_mamba_serve")


def test_reference_reaching_the_program_stops_the_run(tmp_path):
    root = tiny_copy(tmp_path)
    model = root / "bench_port" / "reference" / "model.py"
    model.write_text(model.read_text() + "\n\ndef _bad():\n    import vct_torch\n")
    from bench_port import run

    with pytest.raises(RuntimeError, match="vct_torch"):
        run._check_reference(root / "bench_port")


def _python(args, cwd, path):
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH",)}
    if path:
        env["PYTHONPATH"] = path
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=600)


def test_a_fresh_process_loads_nothing_forbidden(tmp_path):
    """A whole tiny run in its own interpreter; ``run_cell`` raises on a
    forbidden module, and the process checks once more at its end."""
    root = tiny_copy(tmp_path)
    code = ("import sys, time, torch; from bench_port import run; "
            "from bench_port.core.guard import loaded_forbidden; "
            f"r, _ = run.run_cell('tiny_lstm_serve', 3, 0.3, True, torch.device('cpu'), "
            f"time.perf_counter(), bench_dir=__import__('pathlib').Path({str(root)!r}) / "
            "'bench_port'); print(r['correct'], loaded_forbidden())")
    out = _python(["-c", code], root, f"{root}{os.pathsep}{REPO}")
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "True []"


def test_without_a_card_no_result():
    out = _python(["bench_port/run.py", "--workload", "mamba_serve_sad", "--seed", "1",
                   "--seconds", "1", "--trace", "0"], REPO, None)
    assert out.returncode == 2 and out.stdout == ""


def test_without_the_program_no_result(tmp_path):
    """A directory holding only BENCHMARK.json and the benchmark's files."""
    shutil.copytree(REPO / "bench_port", tmp_path / "bench_port",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    code = ("import time, torch; from bench_port import run; "
            "run.run_cell('mamba_serve_sad', 1, 1, False, torch.device('cpu'), time.perf_counter())")
    out = _python(["-c", code], tmp_path, str(tmp_path))
    assert out.returncode != 0 and "vct_torch" in out.stderr and out.stdout == ""
