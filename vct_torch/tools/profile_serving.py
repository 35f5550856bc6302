"""Profile bench-shaped serving steps on the card.

    python3 -m vct_torch.tools.profile_serving [--steps 3] [--config deployed_mamba|ucf50_lstm]
        [--sampling sad|ssim]

One step is what ``chip_smoke.py`` times as clips/s: SAD (or SSIM) frame
selection of a (32, 2T, 80, 80, 3) uint8 batch with ragged lengths, then
the forward of the LRCN with seeded weights: the deployed config (resnet50 in bf16, 3
Mamba blocks, T=60) or the UCF50 one (resnet50 in bf16, rnn_input 512, 4
LSTM layers of H=56, T=40, scan_impl "pallas"). Prints the top kernels by
device time, the device time grouped by kind, and the device busy share of
the profiled window, as JSON lines. Needs an NVIDIA GPU.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import numpy as np
import torch

from vct_torch.core.config import ModelConfig
from vct_torch.data.preprocess import device_sample_clips
from vct_torch.models import build_model

# Config name -> (sequence length, ModelConfig fields).
CONFIGS = {
    "deployed_mamba": (60, dict(scan_impl="pallas")),
    "ucf50_lstm": (40, dict(rnn_type="lstm", rnn_input_size=512, hidden_size=56,
                            rnn_layer=4, scan_impl="pallas")),
}

# Kernel-name fragments -> group, first match wins.
_GROUPS = (
    ("ssim_pair_scores (K4)", ("ssim_pair_kernel",)),
    ("normalize_frames (K6)", ("normalize_frames",)),
    ("pair_scores (K1)", ("pair_scores_kernel",)),
    ("selective_scan (K3)", ("selective_scan_kernel",)),
    ("lstm / gru (K2, K5)", ("rnn_reg_kernel", "rnn_stack_kernel")),
    ("conv / gemm", ("conv", "xmma", "gemm", "cutlass", "implicit", "sm90_")),
    ("batch_norm", ("batch_norm", "bn_fw", "batchnorm")),
    ("sort / top-k", ("sort", "radix", "topk")),
    ("elementwise / reduce", ("elementwise", "reduce", "vectorized", "copy", "fill")),
)


def _group(name: str) -> str:
    low = name.lower()
    for group, frags in _GROUPS:
        if any(f in low for f in frags):
            return group
    return "other"


def _self_device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--steps", type=int, default=3)
    parser.add_argument("--config", choices=sorted(CONFIGS), default="deployed_mamba")
    parser.add_argument("--sampling", choices=("sad", "ssim"), default="sad")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_serving needs an NVIDIA GPU", file=sys.stderr)
        return 1
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    T, fields = CONFIGS[args.config]
    model = build_model(ModelConfig(**fields, compute_dtype="bfloat16"), T, seed=0)
    rng = np.random.RandomState(1)
    raw = torch.from_numpy(rng.randint(0, 256, (32, 2 * T, 80, 80, 3), dtype=np.uint8)).cuda()
    lens = torch.from_numpy(rng.randint(T + 1, 2 * T + 1, size=32)).cuda()

    def step():
        return model(device_sample_clips(raw, T, method=args.sampling, lengths=lens))

    with torch.inference_mode():
        for _ in range(3):
            step()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            start.record()
            for _ in range(args.steps):
                step()
            end.record()
            torch.cuda.synchronize()
    window_us = start.elapsed_time(end) * 1e3
    # Device-side events only: a CPU op's entry repeats its kernels' time.
    kernels = [
        (e.key, _self_device_us(e), e.count) for e in prof.key_averages()
        if str(e.device_type).endswith("CUDA") and _self_device_us(e) > 0
    ]
    total_us = sum(k[1] for k in kernels)
    groups: dict[str, float] = {}
    for name, us, _ in kernels:
        groups[_group(name)] = groups.get(_group(name), 0.0) + us
    top = sorted(kernels, key=lambda k: -k[1])[:20]
    print(json.dumps({"top_kernels": [
        {"name": n[:120], "device_ms_per_step": us / 1e3 / args.steps, "calls_per_step": c / args.steps}
        for n, us, c in top
    ]}))
    print(json.dumps({
        "config": args.config, "sampling": args.sampling, "steps": args.steps, "gpu": gpu,
        "window_ms_per_step": window_us / 1e3 / args.steps,
        "device_ms_per_step": total_us / 1e3 / args.steps,
        "device_busy_share": total_us / window_us if window_us else None,
        "groups_ms_per_step": {g: us / 1e3 / args.steps for g, us in sorted(groups.items())},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
