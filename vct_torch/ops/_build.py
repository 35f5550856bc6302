"""Build and load the port's CUDA kernels (``vct_torch/csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into an object file, all
sources at once, and the objects are linked into one shared library with a
plain C interface, loaded with ``ctypes``. The build happens on first CUDA
use, into ``.vct_torch_build/<hash>/`` at the checkout's root (listed in
``.gitignore``), keyed by a hash of the sources and flags, so a fresh
checkout builds everything from its own sources and an unchanged one reuses
the library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

__all__ = ["HEADERS", "SOURCES", "build_dir", "check", "counters", "fill_shared_memory", "load_kernels"]

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
_BUILD_ROOT = _PKG.parent / ".vct_torch_build"
SOURCES = ("common.cu", "pair_scores.cu", "selective_scan.cu", "selective_scan_bwd.cu",
           "lstm.cu", "lstm_bwd.cu", "ssim.cu", "normalize.cu")
HEADERS = ("rnn_cluster.cuh",)  # included by sources: part of the build's hash
_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
_LIB_NAME = "libvct_torch_kernels.so"

_lock = threading.Lock()
_lib = None
# The kernels' int32 counters, one tensor per (device, stream): zero before
# a launch and set back to zero by the launch's blocks that use them, so
# they are allocated once and never cleared by the host, kernels on one
# stream (which never overlap) share them, and launches on two streams
# never do. A tensor outgrown is kept, not freed: a CUDA graph captured
# with it still writes there.
_counters: dict = {}
_outgrown: list = []


def _nvcc() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return found


def build_dir() -> Path:
    """Directory of the library built from the current sources."""
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((_CSRC / name).read_bytes())
    return _BUILD_ROOT / h.hexdigest()[:16]


def _build(out_dir: Path) -> Path:
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tmp = Path(tempfile.mkdtemp(prefix="tmp-", dir=out_dir))
    try:
        procs = []
        for name in SOURCES:
            obj = tmp / (Path(name).stem + ".o")
            cmd = [nvcc, *_FLAGS, "-c", str(_CSRC / name), "-o", str(obj)]
            procs.append((name, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            )))
        log, failed = [], []
        for name, _, proc in procs:
            out, _ = proc.communicate()
            log.append(f"== {name} (rc {proc.returncode})\n{out}")
            if proc.returncode != 0:
                failed.append(name)
        (out_dir / "build.log").write_text("\n".join(log))
        if failed:
            raise RuntimeError(
                f"nvcc failed on {failed}:\n" + "\n".join(log)
            )
        lib_tmp = tmp / _LIB_NAME
        link = subprocess.run(
            [nvcc, "-shared", *[str(o) for _, o, _ in procs], "-o", str(lib_tmp)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        lib = out_dir / _LIB_NAME
        os.replace(lib_tmp, lib)  # atomic: a concurrent loader sees all or nothing
        return lib
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _declare(lib) -> None:
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    lib.vct_pair_scores.argtypes = [p, p, i, i, ll, i, i, i, i, i, i, i, p]
    lib.vct_pair_scores.restype = i
    lib.vct_ssim_pair_scores.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i, f, f, f, f, p]
    lib.vct_ssim_pair_scores.restype = i
    lib.vct_normalize_frames.argtypes = [p, p, ll, i, p, p, f, p]
    lib.vct_normalize_frames.restype = i
    lib.vct_selective_scan_fwd.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, p]
    lib.vct_selective_scan_fwd.restype = i
    lib.vct_scan_plan.argtypes = [i, i, i, i, i, i]
    lib.vct_scan_plan.restype = i
    lib.vct_selective_scan_bwd.argtypes = [p] * 13 + [i, i, i, i, i, p]
    lib.vct_selective_scan_bwd.restype = i
    for name in ("vct_selective_scan_bwd_scratch", "vct_selective_scan_bwd_counters"):
        getattr(lib, name).argtypes = [i, i, i, i]
        getattr(lib, name).restype = ll
    lib.vct_scan_bwd_plan.argtypes = [i, i, i, i]
    lib.vct_scan_bwd_plan.restype = i
    lib.vct_rnn_fwd.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, p]
    lib.vct_rnn_fwd.restype = i
    lib.vct_rnn_bwd.argtypes = [p, p, p, p, p, p, p, p, p, p, i, i, i, i, p]
    lib.vct_rnn_bwd.restype = i
    lib.vct_rnn_bwd_plan.argtypes = [i, i, i]
    lib.vct_rnn_bwd_plan.restype = i
    lib.vct_rnn_plan.argtypes = [i, i, i, i]
    lib.vct_rnn_plan.restype = i
    lib.vct_rnn_fwd_with.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i, i, p]
    lib.vct_rnn_fwd_with.restype = i
    lib.vct_rnn_bwd_with.argtypes = [p] * 10 + [i, i, i, i, i, i, p]
    lib.vct_rnn_bwd_with.restype = i
    lib.vct_rnn_cluster_plan.argtypes = [i, i, i]
    lib.vct_rnn_cluster_plan.restype = i
    lib.vct_rnn_fwd_fit.argtypes = [i] * 7
    lib.vct_rnn_fwd_fit.restype = i
    lib.vct_rnn_bwd_fit.argtypes = [i] * 6
    lib.vct_rnn_bwd_fit.restype = i
    lib.vct_error_string.argtypes = [i]
    lib.vct_error_string.restype = ctypes.c_char_p
    lib.vct_fill_shared.argtypes = [f, p]
    lib.vct_fill_shared.restype = i


def load_kernels():
    """The loaded kernel library, built first if its sources changed."""
    global _lib
    with _lock:
        if _lib is None:
            lib_path = build_dir() / _LIB_NAME
            if not lib_path.is_file():
                lib_path = _build(lib_path.parent)
            lib = ctypes.CDLL(str(lib_path))
            _declare(lib)
            _lib = lib
        return _lib


def check(lib, err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        msg = lib.vct_error_string(err).decode()
        raise RuntimeError(f"{what} failed: CUDA error {err} ({msg})")


def fill_shared_memory(value: float) -> None:
    """Fill every SM's shared memory with ``value`` on the current CUDA
    stream (``vct_fill_shared``), so that the next kernel on the stream reads
    ``value`` wherever it reads shared memory it did not write. For checks."""
    import torch

    lib = load_kernels()
    check(lib, lib.vct_fill_shared(value, torch.cuda.current_stream().cuda_stream),
          "vct_fill_shared")


def counters(device, stream: int, n: int):
    """At least ``n`` zero int32 counters for kernels on ``stream`` of
    ``device`` (a CUDA stream handle), which the kernels leave zero."""
    import torch

    c = _counters.get((device, stream))
    if c is None or c.numel() < n:
        if c is not None:
            _outgrown.append(c)
        c = torch.zeros(max(n, 4096), dtype=torch.int32, device=device)
        _counters[(device, stream)] = c
    return c
