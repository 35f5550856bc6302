#!/usr/bin/env python3
"""Drive the vct_torch serving path on one NVIDIA GPU and hold its kernels
against their plain PyTorch versions.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 chip_smoke.py

Phases (any failure exits non-zero, and only a full pass prints the last
line):

1. device — the card's name and power limit (nvidia-smi);
2. build — nvcc builds the kernels of ``vct_torch/csrc`` (timed);
3. K1 ``pair_scores`` against ``pair_scores_ref`` on the card: SAD
   bit-exact, flow rtol 1e-6 (both sum exactly in integers);
4. K3 ``selective_scan`` against ``selective_scan_ref`` on the card:
   atol = rtol = 1e-5 (f32, summation order and fused multiply-adds);
5. the main path — the deployed config (resnet50 bf16 backbone, 3 Mamba
   blocks, rnn_input 8, T=60, 80x80, scan_impl "pallas") with seeded
   weights serves three requests of four decoded videos each through
   ``sample_decoded_clips`` and ``classify_and_display``, with the kernels'
   launch counts read around exactly that run; then a bench-shaped batch
   (B=32, L=120, ragged lengths) is timed as clips/s, the kernel path is
   held against the same path with the plain versions substituted (equal
   frame indices, logits atol = rtol = 1e-4, TF32 off), and an f32 copy
   of the model on the card is held against the same model on the CPU
   (logits atol = rtol = 1e-3);
6. timing — one JSON line ``{"kernels": [...]}`` with each kernel's
   launches, error, time, plain time and bound, and a line of extra
   timings at the other shapes.

The last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

import numpy as np

# Published H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, and the
# non-tensor-core f32 rate, used for the integer and f32 ALU work here.
HBM_BYTES_PER_S = 3.35e12
ALU_OPS_PER_S = 67e12

T, H, W = 60, 80, 80


def _gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def _bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / ALU_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def _events_ms(torch, fn, iters: int, warmup: int = 3) -> float:
    """Mean time per call of back-to-back calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _graph_ms(torch, fn, iters: int) -> float:
    """Device time per call: ``iters`` calls captured in one CUDA graph and
    replayed, so host launch overhead is not in the number."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    return _events_ms(torch, graph.replay, 5, warmup=1) / iters


def _check_pair_scores(torch, gen):
    from vct_torch.ops.pair_scores import pair_scores, pair_scores_ref

    shapes = [
        (32, 120, H, W, 3),  # bench-like batch (L = 2T)
        (1, 120, H, W, 3),   # one bucket-padded video, both buckets the
        (1, 240, H, W, 3),   # served requests below use
        (4, 2, H, W, 3),     # L = 2
        (2, 12, 16, 16, 3),  # the kernel-audit geometries: odd H, C=1,
        (1, 9, 11, 44, 3),   # L crossing a chunk boundary
        (2, 10, 8, 48, 3),
        (1, 7, 9, 86, 3),
        (2, 21, 16, 48, 1),
        (3, 13, 7, 5, 1),    # odd H*W*C
    ]
    cases = [(s, torch.randint(0, 256, s, dtype=torch.uint8, generator=gen).cuda()) for s in shapes]
    flat = torch.randint(0, 256, (1 + 2 * 10 * 8 * 8 * 3,), dtype=torch.uint8, generator=gen).cuda()
    cases.append(("unaligned 2x10x8x8x3", flat[1:].view(2, 10, 8, 8, 3)))
    frame = torch.randint(0, 256, (1, 1, H, W, 3), dtype=torch.uint8, generator=gen).cuda()
    cases.append(("all-equal 4x30x80x80x3", frame.expand(4, 30, H, W, 3).contiguous()))
    err = 0.0
    for name, x in cases:
        for method in ("sad", "flow"):
            got, want = pair_scores(x, method), pair_scores_ref(x, method)
            torch.cuda.synchronize()
            if method == "sad" and not torch.equal(got, want):
                raise AssertionError(f"pair_scores sad {name}: not bit-exact")
            torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
            if got.numel():
                err = max(err, (got - want).abs().max().item())
    print(f"K1 pair_scores: {len(cases)} shapes x (sad, flow) agree; max abs err {err}")
    return err


def _scan_inputs(torch, gen, B, L, D, N):
    u = torch.randn(B, L, D, generator=gen)
    delta = torch.rand(B, L, D, generator=gen) * 0.5
    A = -torch.rand(D, N, generator=gen) - 0.1
    Bm = torch.randn(B, L, N, generator=gen)
    Cm = torch.randn(B, L, N, generator=gen)
    return [t.cuda() for t in (u, delta, A, Bm, Cm)]


def _check_selective_scan(torch, gen):
    from vct_torch.ops.selective_scan import selective_scan, selective_scan_ref

    err = 0.0
    # bench-shaped batch; a served request (batch_size 4); VideoMamba width
    for dims in [(32, T, 16, 32), (4, T, 16, 32), (2, 256, 2048, 16)]:
        args = _scan_inputs(torch, gen, *dims)
        for reverse in (False, True):
            got = selective_scan(*args, reverse=reverse)
            want = selective_scan_ref(*args, reverse=reverse)
            torch.cuda.synchronize()
            torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
            err = max(err, (got - want).abs().max().item())
    print(f"K3 selective_scan: deployed (B=32, B=4) and D=2048 shapes, fwd and reverse agree; "
          f"max abs err {err}")
    return err


def _synthetic_videos(lengths, seed):
    """Decoded uint8 videos with static runs (tied SAD scores) and noisy runs."""
    rng = np.random.RandomState(seed)
    videos = []
    for n in lengths:
        frames, scene = [], rng.randint(0, 256, (H, W, 3), dtype=np.uint8)
        while len(frames) < n:
            run = rng.randint(1, 7)
            noisy = rng.rand() < 0.5
            for _ in range(run):
                f = scene
                if noisy:
                    f = np.clip(scene.astype(np.int16) + rng.randint(-8, 9, scene.shape), 0, 255)
                frames.append(f.astype(np.uint8))
            scene = rng.randint(0, 256, (H, W, 3), dtype=np.uint8)
        videos.append(np.stack(frames[:n]))
    return videos


def _set_scan_impl(model, impl):
    from vct_torch.models.ssm import ParallelMamba

    for m in model.modules():
        if isinstance(m, ParallelMamba):
            m.scan_impl = impl


def _main_path(torch, gpu):
    import vct_torch.data.preprocess as preprocess
    from vct_torch.core.config import ModelConfig
    from vct_torch.models import build_model
    from vct_torch.ops.pair_scores import pair_scores, pair_scores_ref
    from vct_torch.ops.selective_scan import selective_scan
    from vct_torch.serve.deployment import classify_and_display, sample_decoded_clips

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    deployed = dict(cnn_backbone="resnet50", rnn_type="mamba", rnn_input_size=8,
                    rnn_layer=3, scan_impl="pallas")
    cfg = ModelConfig(**deployed, compute_dtype="bfloat16")
    model = build_model(cfg, T, seed=0)
    class_names = [f"class_{i}" for i in range(cfg.num_classes)]

    # --- the main path: three requests of four decoded videos each -------
    lengths = [40, 75, 121, 200, 60, 100, 150, 55, 120, 61, 180, 90]
    videos = _synthetic_videos(lengths, seed=0)
    names = [f"@user{i}_video_{1000 + i}.mp4" for i in range(len(videos))]
    pair_scores.launches = 0
    selective_scan.launches = 0
    results = []
    for r in range(3):
        batch = slice(4 * r, 4 * r + 4)
        clips = sample_decoded_clips(videos[batch], "sad", T)
        results += classify_and_display(model, clips, names[batch], class_names, batch_size=4)
    torch.cuda.synchronize()
    launches = {"pair_scores": pair_scores.launches, "selective_scan": selective_scan.launches}
    want = {"pair_scores": sum(n > T for n in lengths), "selective_scan": 3 * cfg.rnn_layer}
    print(f"main path launches {launches} (expected {want})")
    if launches != want:
        raise AssertionError(f"kernel launches {launches} != expected {want}")
    if [r["video_name"] for r in results] != names:
        raise AssertionError("served results do not match the requests")
    for r in results:
        scores = np.asarray(r["scores"])
        if not (np.isfinite(scores).all() and abs(scores.sum() - 1.0) < 1e-5):
            raise AssertionError(f"bad probabilities for {r['video_name']}: {scores}")

    # --- a bench-shaped batch: B=32, L=120 raw, ragged lengths -----------
    rng = np.random.RandomState(1)
    raw = torch.from_numpy(rng.randint(0, 256, (32, 2 * T, H, W, 3), dtype=np.uint8)).cuda()
    lens = torch.from_numpy(rng.randint(T + 1, 2 * T + 1, size=32)).cuda()

    def sample():
        return preprocess.device_sample_clips(raw, T, method="sad", lengths=lens)

    with torch.inference_mode():
        x = sample()
        feats = model(x, features_only=True)
        step_ms = _events_ms(torch, lambda: model(sample()), iters=10)
        sample_ms = _events_ms(torch, sample, iters=10)
        forward_ms = _events_ms(torch, lambda: model(x), iters=10)
        backbone_ms = _events_ms(torch, lambda: model(x, features_only=True), iters=10)
        head_ms = _events_ms(torch, lambda: model(feats, from_features=True), iters=10)
    serving = {
        "serving_clips_per_s": 32 * 1e3 / step_ms, "batch": 32, "raw_len": 2 * T, "T": T,
        "ms_per_batch": step_ms, "sampling_ms": sample_ms, "forward_ms": forward_ms,
        "backbone_ms": backbone_ms, "head_ms": head_ms, "gpu": gpu,
    }
    print(json.dumps(serving))

    # --- kernel path vs the same path with the plain versions ------------
    torch.backends.cudnn.deterministic = True  # same conv algorithms on both paths
    with torch.inference_mode():
        idx_k = preprocess.sample_indices(raw, T, "sad", lens)
        logits_k = model(sample())
        _set_scan_impl(model, "scan")
        with mock.patch.object(preprocess, "pair_scores", pair_scores_ref):
            idx_p = preprocess.sample_indices(raw, T, "sad", lens)
            logits_p = model(sample())
        _set_scan_impl(model, "pallas")
    if not torch.equal(idx_k, idx_p):
        raise AssertionError("kernel and plain SAD selection picked different frames")
    torch.testing.assert_close(logits_k, logits_p, atol=1e-4, rtol=1e-4)
    path_err = (logits_k - logits_p).abs().max().item()
    print(f"kernel path == plain path: frame indices equal, logits max abs err {path_err}")

    # --- the card against the CPU, f32, same seed -------------------------
    cfg32 = ModelConfig(**deployed)
    with torch.inference_mode():
        on_card = build_model(cfg32, T, seed=0)(sample()[:2]).cpu()
        x_cpu = preprocess.device_sample_clips(raw[:2].cpu(), T, method="sad", lengths=lens[:2].cpu())
        on_cpu = build_model(cfg32, T, device="cpu", seed=0)(x_cpu)
    torch.testing.assert_close(on_card, on_cpu, atol=1e-3, rtol=1e-3)
    print(f"f32 card vs CPU logits max abs err {(on_card - on_cpu).abs().max().item()}")
    return launches


def _kernel_timings(torch, gen, launches, errs, gpu):
    from vct_torch.ops.pair_scores import pair_scores, pair_scores_ref
    from vct_torch.ops.selective_scan import selective_scan, selective_scan_ref

    def k1(B, L, method="sad"):
        x = torch.randint(0, 256, (B, L, H, W, 3), dtype=torch.uint8, generator=gen).cuda()
        F = H * W * 3
        bound, by = _bound_ms(B * L * F + B * (L - 1) * 4, 3 * B * (L - 1) * F)
        return {
            "shape": [B, L, H, W, 3], "method": method,
            "ms": _events_ms(torch, lambda: pair_scores(x, method), 20),
            "device_ms": _graph_ms(torch, lambda: pair_scores(x, method), 20),
            "plain_ms": _events_ms(torch, lambda: pair_scores_ref(x, method), 5),
            "bound_ms": bound, "bound_by": by,
        }

    def k3(B, L, D, N):
        args = _scan_inputs(torch, gen, B, L, D, N)
        bound, by = _bound_ms(4 * (3 * B * L * D + 2 * B * L * N + D * N), 7 * B * L * D * N)
        return {
            "shape": [B, L, D, N],
            "ms": _events_ms(torch, lambda: selective_scan(*args), 20),
            "device_ms": _graph_ms(torch, lambda: selective_scan(*args), 20),
            "plain_ms": _events_ms(torch, lambda: selective_scan_ref(*args), 3),
            "bound_ms": bound, "bound_by": by,
        }

    t1, t3 = k1(32, 2 * T), k3(32, T, 16, 32)
    kernels = [
        {"name": "pair_scores", "route": "cuda", "source": "vct_torch/csrc/pair_scores.cu",
         "replaces": "vct/ops/pair_scores_pallas.py:119", "launches": launches["pair_scores"],
         "max_abs_err": errs["pair_scores"], "ms": t1["ms"], "plain_ms": t1["plain_ms"],
         "bound_ms": t1["bound_ms"], "bound_by": t1["bound_by"], "library_ms": None,
         "device_ms": t1["device_ms"], "shape": t1["shape"]},
        {"name": "selective_scan", "route": "cuda", "source": "vct_torch/csrc/selective_scan.cu",
         "replaces": "vct/ops/selective_scan_pallas.py:111",
         "launches": launches["selective_scan"], "max_abs_err": errs["selective_scan"],
         "ms": t3["ms"], "plain_ms": t3["plain_ms"], "bound_ms": t3["bound_ms"],
         "bound_by": t3["bound_by"], "library_ms": None,
         "device_ms": t3["device_ms"], "shape": t3["shape"]},
    ]
    extra = {"extra_timings": {
        "pair_scores_B1_L120_sad": k1(1, 2 * T),
        "pair_scores_B32_L120_flow": k1(32, 2 * T, "flow"),
        "selective_scan_D2048_N16": k3(2, 256, 2048, 16),
    }, "gpu": gpu}
    print(json.dumps(extra))
    return kernels


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from vct_torch.ops import _build

    gpu = _gpu_line()
    print(f"gpu: {gpu}", flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    t0 = time.perf_counter()
    _build.load_kernels()
    print(f"build: {time.perf_counter() - t0:.2f} s into {_build.build_dir()}", flush=True)
    log = (_build.build_dir() / "build.log")
    if log.is_file():
        print("\n".join(line for line in log.read_text().splitlines() if "Used" in line))

    gen = torch.Generator().manual_seed(0)
    errs = {"pair_scores": _check_pair_scores(torch, gen),
            "selective_scan": _check_selective_scan(torch, gen)}
    launches = _main_path(torch, gpu)
    kernels = _kernel_timings(torch, gen, launches, errs, gpu)
    print(json.dumps({"kernels": kernels, "gpu": gpu}))
    print(_gpu_line())  # name, power limit: exactly as nvidia-smi prints them
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
