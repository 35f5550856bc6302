#!/usr/bin/env python3
"""Drive the vct_torch serving and training paths on one NVIDIA GPU and hold
their kernels against their plain PyTorch versions.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 chip_smoke.py

Phases (any failure exits non-zero, and only a full pass prints the last
line):

1. device — the card's name and power limit (nvidia-smi);
2. build — nvcc builds the kernels of ``vct_torch/csrc`` (timed) and each
   kernel's registers, stack frame and spills are printed;
3. K1 ``pair_scores`` against ``pair_scores_ref`` on the card, SAD and
   flow both bit-equal (both sum exactly in integers and round once), each
   launch just after NaN was left in every SM's shared memory, each shape
   printed with its plan (``plan``: transitions a chunk, bands, cluster,
   threads, stages, blocks): the bench step, both served buckets, one
   decoded 320x240 video, L=2, the kernel-audit geometries, frames off a
   multiple of 16 bytes and an unaligned view (the byte path), a frame of
   one 16-byte word, one decoded 1080p video (more bands than a cluster),
   forced plans whose chunks and bands do not divide the clip on both
   paths, a served bucket in 20 bands, and all-equal frames, which must
   score exactly 0; then three CUDA-graph replays of a served bucket;
4. K4 ``ssim_pair_scores`` against ``ssim_pair_scores_ref`` on the card,
   each launch just after NaN was left in every SM's shared memory, each
   shape printed with its plan (``plan``: transitions a chunk, output rows
   a band, threads, blocks): atol 2e-6 (vct's tolerance) and bit-equal in
   every case (the window sums are exact, the f32 operations unfused and in
   the same order up to exact scalings by two, the mean summed in f64), at
   the bench shape, both served buckets, L=2, the kernel-audit geometries,
   the smallest 3x3 frame, H=3, L-1 and H-2 prime, row lengths 132, 258
   and 5 and an unaligned view (the byte path), a row of 384 bytes (two
   column groups), rows at decoded widths (320, 3840 and, on the byte
   path, 426 pixels: 4, 45 and 5 column groups), forced plans whose chunks
   and bands do not divide the clip, and all-equal frames, which must score
   exactly 1.0; then three CUDA-graph replays of a served bucket, each
   bit-equal;
5. K6 ``normalize_frames`` against ``normalize_frames_ref``: bit-exact, for
   the identity and an ImageNet mean/std, at (32, 60, 80, 80, 3), an odd
   element count, an unaligned view and C=1;
6. K3 ``selective_scan`` against ``selective_scan_ref`` on the card:
   atol = rtol = 1e-5 (f32: h is rounded as the plain version rounds it, y's
   sum over N runs in another order), both directions, each launch just
   after NaN was left in every SM's shared memory, each shape printed with
   its plan (``plan``: states a lane, lanes and warps a channel, state
   tiles, block threads, chunk steps): the deployed shapes (B=32 and a served B=4), VideoMamba's width
   (D=2048, N=16, L=256), the sweep's top N=64 at D=32, N = 1, 8, 12, 24,
   33, 64, 100 at the deployed widths, and L=1;
7. K2 ``lstm_stack`` / ``gru_stack`` and K5 ``lstm_scan`` / ``gru_scan``
   against their plain versions on the card, TF32 off, atol = rtol = 1e-5,
   each launched just after NaN was left in every SM's shared memory (a
   kernel that reads shared memory it did not write fails), and
   each shape printed with the kernel design it took (``design``, checked:
   "registers" for H <= 64, "columns" above): the bench stack (B=32, T=40,
   H=56, L=4), a served request (B=4), one video (B=1), the register
   design's edges (H=64 at L=4, the default width H=32 at T=60, T=130 over
   three staged chunks, H=16 with two k-slices), the "columns" design's
   shared-memory plans (H=65, its first shape; H=96 LSTM: W_hh staged,
   W_ih read through L2; H=256: both weights through L2; H=512, T=128: the
   previous layer's outputs through L2 too), an odd H=5, T=1, and K5
   forward and through the time flip; then the backward kernels (K3's
   ``selective_scan_bwd.cu``, K2/K5's ``lstm_bwd.cu``) against autograd
   through the plain versions, each gradient within 1e-5 of its largest
   magnitude, each launch after the NaN fill: K3 at the deployed step and
   L = 130 (three chunks) both directions, VideoMamba's width and N = 1, 24,
   64, 100, 300 (two state tiles), each shape printed with its plan
   (``bwd_plan``); the LSTM and GRU
   stacks, each shape printed with its backward design (checked:
   "registers" for H <= 64, "columns" above), at the bench stack, a
   request, the default width, H = 1, 5, 17, 64 (the register design's
   widest), T=130 over three chunks, and H = 65, 256; K5 at the bench shape
   both directions; two runs and a CUDA-graph replay bit-equal; and every
   register-design instance of the backward must report 0 spill bytes in
   the build's ptxas log;
8. the Mamba path — the deployed config (resnet50 bf16 backbone, 3 Mamba
   blocks, rnn_input 8, T=60, 80x80, scan_impl "pallas") with seeded
   weights serves three requests of four decoded videos each through
   ``sample_decoded_clips`` and ``classify_and_display``, with the kernels'
   launch counts read around exactly that run; then a bench-shaped batch
   (B=32, L=120, ragged lengths) is timed as clips/s, the kernel path is
   held against the same path with the plain versions substituted (equal
   frame indices, logits atol = rtol = 1e-4, TF32 off), and an f32 copy
   of the model on the card is held against the same model on the CPU
   (logits atol = rtol = 1e-3);
9. the SSIM path — the same deployed model serves three requests of four
   decoded videos with ``ssim`` (one request names ``ssim_most_unique``)
   selection, launch counts read around exactly that run (K4 once per video
   longer than T, K1 never, K3 three times per request), and its
   bench-shaped step is timed and held the same way under the label
   ``deployed_mamba_ssim``;
10. the LSTM/GRU path — the UCF50 geometry (resnet50 bf16, rnn_input 512,
   H=56, 4 layers, T=40, 80x80, scan_impl "pallas") serves one request of
   four videos for each of four heads (LSTM and GRU, uni- and
   bidirectional), with the launch counts read around each: one K2 launch
   per unidirectional forward, 2 x 4 K5 launches per bidirectional one;
   for the LSTM uni head a bench-shaped batch (B=32, L=80, ragged lengths)
   is timed as clips/s, held against the plain path (equal frame indices,
   logits atol = rtol = 1e-4) and against the CPU in f32 (1e-3);
11. the training path — for the deployed Mamba and the UCF50 LSTM at full
    width, ``python -m vct_torch.train``'s ``main`` on 40 synthetic clips
    (32 train, 8 test; B=32; 2 epochs), its epoch lines and metric block
    checked by ``extract_metrics`` and the forward and backward kernels'
    launches read around it; from the same weights, 5 Adam steps of the head
    on the same backbone features through the kernels and through the plain
    versions, dropout 0 and TF32 off, losses within 1e-4 relative and
    parameters too (in norm, over the elements whose gradient stayed above
    1e-5 of its tensor's largest; the rest within Adam's 2 lr a step), every
    trained parameter's kernel-path gradient present and within 1e-5 of the
    plain path's; the steady-state train step timed by events as
    ``train_clips_per_s`` with its launches a step, the backbone's forward and
    the head's step alone, and a ``torch.profiler`` breakdown of a step's
    device time by kernel; one train step each of the GRU and bidirectional
    UCF50 heads, launches checked;
12. resume, observability, warm start and weight import — for both
    configurations at full width, ``python -m vct_torch.train``'s main with
    dropout 0.25 and the plateau decay on (``RESUME_ARGS``: a learning rate of
    1e-11 moves the val loss by far less than the plateau's 1e-6, so the
    learning rate is lowered at epochs 2 and 3 by construction): 3 epochs
    uninterrupted, then with ``train.resume`` crashed after epoch 1 and after
    epoch 2 and resumed to 3, the last part with ``train.history_path``,
    ``train.log_every 1`` and ``train.profile_dir``; the final parameters and
    the three epoch losses must be bit-equal to the uninterrupted run's, each
    resumed epoch must launch the kernels as often as the same uninterrupted
    epoch (counters read around each epoch's train loop), the history must
    hold three epochs and the step times, one step line a step, and the
    trace's K3 or K2 forward and backward kernels must number what the
    counters counted in the traced epoch; ``save_train_state``'s time and
    file size are printed; a fourth Trainer with ``train.init_from`` the
    resumed checkpoint must start bit-equal to it. Then a seeded torchvision
    resnet50 state_dict (key list written out here) goes through
    ``model.backbone_weights`` into the deployed model, each tensor checked
    by an independent name map; a seeded reference-LRCN state_dict of the
    deployed config through ``vct_torch.tools.port_reference`` on the card
    and on the CPU; ``load_model`` on both; one 4-video SAD request served on
    the card through ``classify_and_display`` (K1 and K3 launches checked),
    its frames the CPU's (pixels within 1e-6: the card's /255 multiplies by
    the reciprocal) and its logits within 1e-4 (atol = rtol, TF32 off),
    labels equal;
13. timing — one JSON line ``{"kernels": [...]}`` with each kernel's
    launches, error, time, plain time, bound and, for K2/K5, the design,
    ``us_per_step`` (device time over T*L) and cuDNN's ``nn.LSTM`` /
    ``nn.GRU`` time (``library_ms`` by events; ``library_device_ms`` replayed
    from a CUDA graph or, where capture fails (cuDNN's LSTM backward at
    T = 130), the time its kernels keep the card busy under
    ``torch.profiler``, as ``library_device_via`` says), for K3 its plan, ``us_per_step``
    (device time over L), ``expf_bound_ms`` (one expf a state and step
    at the SFUs' rate) and ``launch_ms`` (the launch without the wrapper's
    checks, by events), and a line of extra timings at the other shapes,
    with the LSTM stack's backward at T = 130 beside cuDNN's
    (``lstm_stack_bwd_T130``), K3's backward at VideoMamba's shape
    (``selective_scan_bwd_videomamba``), K3's device time under S = 1 and 2, each
    with the plan's 128-thread blocks and 64-step chunks, 64- or 256-thread
    blocks, or 32-step chunks, at five shapes (``selective_scan_plans``), and K4's device time under
    its plan and, for each K, the two band heights whose block counts lie
    either side of two an SM, each checked bit-equal first, at the three
    main-path shapes and one decoded 320x240 video
    (``ssim_pair_scores_plans``); K1's time by events, its bare launch
    (``launch_ms``, without the wrapper's checks), its device time and its
    plan at the bench step (SAD and flow), both served buckets and one
    decoded 320x240 video, and its device time under the plan's choice and
    its neighbours, each checked bit-equal first, at the four SAD shapes
    (``pair_scores_plans``). K6 is on no serving path (as in vct): its
    launches are 0. ``_k4_timing`` and ``_k1_timing`` use only the public
    names of their kernels' modules (and K1's ``plan`` and ``_launch`` where
    they exist), so they can time an older checkout's kernels too: load this
    file by its path from that checkout's root, or, for K1, run
    ``python3 chip_smoke.py --k1-timing ROOT``, which prints only
    ``k1_timings`` of the package at ROOT. The backward rows (launches from
    the training path) carry the time of the whole backward entry point,
    autograd through the plain version as ``plain_ms``, and for LSTM/GRU
    cuDNN's backward alone as ``library_ms``, and both timed by the same
    profiler union as ``device_busy_ms`` and ``library_busy_ms`` (one method
    for both where cuDNN's capture fails); K3's its plan, ``us_per_step``
    and ``kernel_launches`` (device launches a call, ``torch.profiler``);
    ``python3 chip_smoke.py --bwd-timing ROOT`` prints only the backward
    entry points' times (``bwd_timings``: K3's at the deployed step and
    VideoMamba's shape with its launches a call, K2/K5's) for the package at
    ROOT, an older checkout's too.

The last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import re
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
# expf's MUFU.EX2 on the special-function units: 16 a clock per SM (Hopper
# white paper), 132 SMs at the 1.98 GHz boost clock.
SFU_EXP_PER_S = 16 * 132 * 1.98e9
# K3 backward's least f32 work a (batch, step, channel, state): dh, its
# products with B, C, h_{t-1}, a, dt and u, and the carry (vct_torch/csrc/
# selective_scan_bwd.cu), beside one expf.
SCAN_BWD_FLOPS = 12

T, H, W = 60, 80, 80

# The deployed config (bench.py VCT_BENCH_MODEL=mamba), with the kernels' scan_impl.
DEPLOYED = dict(cnn_backbone="resnet50", rnn_type="mamba", rnn_input_size=8, rnn_layer=3,
                scan_impl="pallas")
# K4's least work in instructions, as counted in vct_torch/csrc/ssim.cu's
# note: per element of a frame (each frame's window sums formed once) and per
# valid (pair, element), plus one reciprocal per (pair, element).
SSIM_FRAME_INSTRUCTIONS = 11
SSIM_PAIR_INSTRUCTIONS = 17
# Instruction issue: 128 a clock per SM (four schedulers of 32 lanes), 132
# SMs at the 1.98 GHz boost clock of SFU_EXP_PER_S; MUFU.RCP on the 16-a-clock pipe.
ISSUE_PER_S = 128 * 132 * 1.98e9
SFU_RCP_PER_S = SFU_EXP_PER_S
# K4's plans are timed at the main-path shapes and one decoded 320x240 video.
SSIM_PLAN_SHAPES = [(32, 2 * T, H, W, 3), (1, 2 * T, H, W, 3), (1, 4 * T, H, W, 3),
                    (1, 2 * T, 240, 320, 3)]

# The UCF50 geometry bench.py times by default, with the kernels' scan_impl.
T_UCF50 = 40
UCF50 = dict(cnn_backbone="resnet50", rnn_input_size=512, hidden_size=56, rnn_layer=4,
             rnn_out="all", scan_impl="pallas")
# K2 / K5 entry points and the TPU kernels they replace.
RNN_KERNELS = {
    "lstm_stack": "vct/ops/lstm_pallas.py:354",
    "gru_stack": "vct/ops/lstm_pallas.py:355",
    "lstm_scan": "vct/ops/lstm_pallas.py:352",
    "gru_scan": "vct/ops/lstm_pallas.py:353",
}


def _gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def _ptxas_lines(log: str) -> list[str]:
    """One line per compiled kernel from nvcc's ``-Xptxas -v`` log: its
    mangled name, registers, and stack frame and spills."""
    rows, name, spill = [], None, ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif "spill stores" in line:
            spill = line.strip()
        elif "Used" in line and name:
            rows.append(f"  {name}: {line.split('Used', 1)[1].strip()}; {spill}")
            name, spill = None, ""
    return rows


def _bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / ALU_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def _ssim_bound_ms(B: int, L: int, H_: int, W_: int, C: int) -> tuple[float, str]:
    """K4's least time: the larger of its bytes over the memory rate, its
    instructions over the issue rate and its reciprocals over the MUFU rate.
    Every input byte read once and each f32 score written once; each frame's
    window sums formed once (SSIM_FRAME_INSTRUCTIONS per element of every
    frame), the rest per pair. Instructions are the unit counted, and the
    bound is named "operations" as the kernels line names every count."""
    frame_elems = (H_ - 2) * (W_ - 2) * C
    n_bytes = B * L * H_ * W_ * C + B * (L - 1) * 4
    n_instr = (SSIM_FRAME_INSTRUCTIONS * B * L + SSIM_PAIR_INSTRUCTIONS * B * (L - 1)) * frame_elems
    t_bytes, t_instr = n_bytes / HBM_BYTES_PER_S, n_instr / ISSUE_PER_S
    t_rcp = B * (L - 1) * frame_elems / SFU_RCP_PER_S
    return max(t_bytes, t_instr, t_rcp) * 1e3, ("bytes" if t_bytes >= max(t_instr, t_rcp)
                                                 else "operations")


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


# K1 shapes the check and the timings share: the bench step, the two served
# buckets, and one decoded 320x240 video (scored before any resize).
K1_SHAPES = [(32, 2 * T, H, W, 3), (1, 2 * T, H, W, 3), (1, 4 * T, H, W, 3),
             (1, 2 * T, 240, 320, 3)]


def _k1_bound_ms(B: int, L: int, H_: int, W_: int, C: int) -> tuple[float, str]:
    """K1's least time: every frame read once and each f32 score written
    once, against three integer operations a byte of each pair."""
    F = H_ * W_ * C
    return _bound_ms(B * L * F + B * (L - 1) * 4, 3 * B * (L - 1) * F)


def _check_pair_scores(torch, gen):
    from vct_torch.ops import _build
    from vct_torch.ops.pair_scores import _launch, pair_scores, pair_scores_ref, plan

    shapes = K1_SHAPES + [
        (4, 2, H, W, 3),     # L = 2
        (2, 12, 16, 16, 3),  # the kernel-audit geometries: odd H, C=1,
        (1, 9, 11, 44, 3),   # L crossing a chunk boundary
        (2, 10, 8, 48, 3),
        (1, 7, 9, 86, 3),
        (2, 21, 16, 48, 1),
        (3, 13, 7, 5, 1),    # odd H*W*C: the byte path
        (1, 9, 5, 7, 3),     # 105 bytes a frame: the byte path
        (2, 9, 4, 4, 1),     # a frame of one 16-byte word: one band
        (1, 5, 1080, 1920, 3),  # one decoded 1080p video: more bands than a cluster
    ]
    cases = [(s, torch.randint(0, 256, s, dtype=torch.uint8, generator=gen).cuda(), None)
             for s in shapes]
    flat = torch.randint(0, 256, (1 + 2 * 10 * 8 * 8 * 3,), dtype=torch.uint8, generator=gen).cuda()
    cases.append(("unaligned 2x10x8x8x3", flat[1:].view(2, 10, 8, 8, 3), None))
    frame = torch.randint(0, 256, (1, 1, H, W, 3), dtype=torch.uint8, generator=gen).cuda()
    static = frame.expand(4, 30, H, W, 3).contiguous()
    cases.append(("all-equal 4x30x80x80x3", static, None))
    # Forced plans whose chunks and bands do not divide the clip, on the
    # vector path (162 words a frame) and the byte path (2280 bytes), and
    # bands beyond a cluster on one served bucket.
    for K, nb in ((1, 1), (3, 5), (7, 17)):
        for shape in ((1, 11, 18, 48, 3), (2, 24, 19, 40, 3)):
            x = torch.randint(0, 256, shape, dtype=torch.uint8, generator=gen).cuda()
            cases.append((f"{shape} K={K} bands={nb}", x, plan(*shape, K, nb)))
    x = torch.randint(0, 256, (1, 2 * T, H, W, 3), dtype=torch.uint8, generator=gen).cuda()
    cases.append((f"(1, {2 * T}, {H}, {W}, 3) K=7 bands=20", x, plan(*x.shape, 7, 20)))
    for name, x, forced in cases:
        p = plan(*x.shape) if forced is None else forced
        for method in ("sad", "flow"):
            _build.fill_shared_memory(float("nan"))  # a stale read of shared memory fails the check
            got = (pair_scores(x, method) if forced is None
                   else _launch(x, forced, method == "flow"))
            want = pair_scores_ref(x, method)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"pair_scores {method} {name}: not bit-equal, max abs err "
                                     f"{(got - want).abs().max().item()}")
            if x is static and bool(got.any()):
                raise AssertionError(f"pair_scores {method}: all-equal frames do not score 0")
        print(f"  K1 {name}: plan {p['design']} K={p['chunk_pairs']} bands={p['bands']} "
              f"cluster={p['cluster']} threads={p['threads']} "
              f"blocks={p['blocks']}")
    # Three replays of a CUDA graph of a served bucket.
    x = torch.randint(0, 256, (1, 2 * T, H, W, 3), dtype=torch.uint8, generator=gen).cuda()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        pair_scores(x)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y = pair_scores(x)
    replays = []
    for _ in range(3):
        _build.fill_shared_memory(float("nan"))
        graph.replay()
        replays.append(y.clone())
    torch.cuda.synchronize()
    if not all(torch.equal(r, pair_scores_ref(x)) for r in replays):
        raise AssertionError("pair_scores: CUDA graph replays differ from the plain version")
    print(f"K1 pair_scores: {len(cases)} shapes and plans x (sad, flow) bit-equal, each after a "
          f"NaN fill of shared memory; all-equal frames score 0; 3 graph replays bit-equal; "
          f"max abs err 0.0")
    return 0.0


def _k1_timing(torch, gen, B: int, L: int, H_: int = H, W_: int = W, method: str = "sad") -> dict:
    """K1 on (B, L, H_, W_, 3) random frames: its plan, time by events and
    from a CUDA graph, the bare launch (where the package has one), the
    plain version's time and the bound. Only the public names of
    ``vct_torch.ops.pair_scores`` besides, so an older package (one with no
    ``plan``) is timed the same way."""
    from vct_torch.ops import pair_scores as k1

    x = torch.randint(0, 256, (B, L, H_, W_, 3), dtype=torch.uint8, generator=gen).cuda()
    bound, by = _k1_bound_ms(B, L, H_, W_, 3)
    p = k1.plan(B, L, H_, W_, 3) if hasattr(k1, "plan") else None
    launch_ms = None
    if p is not None and hasattr(k1, "_launch"):
        launch_ms = _events_ms(torch, lambda: k1._launch(x, p, method == "flow"), 50)
    return {
        "shape": [B, L, H_, W_, 3], "method": method, "plan": p,
        "ms": _events_ms(torch, lambda: k1.pair_scores(x, method), 50),
        "launch_ms": launch_ms,
        "device_ms": _graph_ms(torch, lambda: k1.pair_scores(x, method), 20),
        "plain_ms": _events_ms(torch, lambda: k1.pair_scores_ref(x, method), 5),
        "bound_ms": bound, "bound_by": by,
    }


def _k1_neighbours(B: int, L: int, H_: int, W_: int, C: int) -> list[tuple[str, int, int]]:
    """(design, K, bands) of the plan's choice and its neighbours: the other
    design; in the "bands" design, half and twice the choice's K, the K of
    one chunk more and one fewer, the whole clip in one chunk, each with half
    and twice its bands."""
    from vct_torch.ops.pair_scores import plan

    p = plan(B, L, H_, W_, C)
    bands = p if p["design"] == "bands" else plan(B, L, H_, W_, C, design="bands")
    K, nb, pairs, chunks = bands["chunk_pairs"], bands["bands"], L - 1, bands["chunks"]
    ks = {K, max(1, K // 2), min(pairs, 2 * K), pairs, -(-pairs // (chunks + 1))}
    if chunks > 1:
        ks.add(-(-pairs // (chunks - 1)))
    out = [(p["design"], p["chunk_pairs"], p["bands"])]
    try:
        q = plan(B, L, H_, W_, C, design="chunks")
        out.append(("chunks", q["chunk_pairs"], q["bands"]))
    except ValueError:
        pass
    for k in sorted(ks):
        for b in sorted({nb, max(1, nb // 2), 2 * nb}):
            try:
                q = plan(B, L, H_, W_, C, k, b, "bands")
            except ValueError:
                continue
            if ("bands", q["chunk_pairs"], q["bands"]) not in out:
                out.append(("bands", q["chunk_pairs"], q["bands"]))
    return list(dict.fromkeys(out))


def _k1_plans(torch, gen, B: int, L: int, H_: int, W_: int, C: int) -> dict:
    """K1's device time under the plan's choice and its neighbours, each
    checked bit-equal to the plain version (SAD) first."""
    from vct_torch.ops.pair_scores import _launch, pair_scores_ref, plan

    x = torch.randint(0, 256, (B, L, H_, W_, C), dtype=torch.uint8, generator=gen).cuda()
    want = pair_scores_ref(x)
    times = {}
    for design, K, nb in _k1_neighbours(B, L, H_, W_, C):
        p = plan(B, L, H_, W_, C, K, nb, design)
        if not torch.equal(_launch(x, p, False), want):
            raise AssertionError(f"pair_scores: plan {design} K={K} bands={nb} not bit-equal")
        key = (f"{design}_K{K}_bands{nb}_cluster{p['cluster']}_blocks{p['blocks']}"
               f"_threads{p['threads']}")
        times[key] = _graph_ms(torch, lambda: _launch(x, p, False), 20)
    return {"shape": [B, L, H_, W_, C], "plan": plan(B, L, H_, W_, C), "device_ms": times}


def _k4_timing(torch, gen, B: int, L: int, H_: int = H, W_: int = W) -> dict:
    """K4 on (B, L, H_, W_, 3) random frames: its plan, time by events and
    from a CUDA graph, the plain version's time and the bound. Only the
    public names of ``vct_torch.ops.ssim``, so an older package (one with
    no ``plan``) is timed the same way."""
    from vct_torch.ops import ssim

    x = torch.randint(0, 256, (B, L, H_, W_, 3), dtype=torch.uint8, generator=gen).cuda()
    bound, by = _ssim_bound_ms(B, L, H_, W_, 3)
    return {
        "shape": [B, L, H_, W_, 3],
        "plan": ssim.plan(B, L, H_, W_, 3) if hasattr(ssim, "plan") else None,
        "ms": _events_ms(torch, lambda: ssim.ssim_pair_scores(x), 20),
        "device_ms": _graph_ms(torch, lambda: ssim.ssim_pair_scores(x), 20),
        "plain_ms": _events_ms(torch, lambda: ssim.ssim_pair_scores_ref(x), 3, warmup=1),
        "bound_ms": bound, "bound_by": by, "bound_counts": "instructions",
    }


def _k4_plans(torch, gen, B: int, L: int, H_: int, W_: int, C: int) -> dict:
    """K4's device time under the plan's choice and, for each K, the two
    band heights R whose block counts lie either side of RESIDENT_BLOCKS
    (two an SM; at the bench shape the whole frame and half of it), each
    checked bit-equal to the plain version first."""
    from vct_torch.ops.ssim import (MAX_CHUNK_PAIRS, RESIDENT_BLOCKS, _constants, _launch, plan,
                                    ssim_pair_scores_ref)

    x = torch.randint(0, 256, (B, L, H_, W_, C), dtype=torch.uint8, generator=gen).cuda()
    want, constants = ssim_pair_scores_ref(x), _constants(3, 255.0)
    chosen = plan(B, L, H_, W_, C)
    heights = sorted({-(-(H_ - 2) // n) for n in range(1, H_ - 1)}, reverse=True)
    plans = {(chosen["chunk_pairs"], chosen["band_rows"])}
    for K in range(1, MAX_CHUNK_PAIRS + 1):
        blocks = [(R, B * -(-(L - 1) // K) * -(-(H_ - 2) // R)) for R in heights]
        below = [R for R, n in blocks if n < RESIDENT_BLOCKS]
        above = [R for R, n in blocks if n >= RESIDENT_BLOCKS]
        plans.update((K, R) for R in below[-1:] + above[:1 if below else 2])
    times = {}
    for K, R in sorted(plans):
        p = plan(B, L, H_, W_, C, K, R)
        got = _launch(x, p, constants)
        if not torch.equal(got, want):
            raise AssertionError(f"ssim_pair_scores: plan K={K} R={R} not bit-equal")
        times[f"K{K}_R{R}_blocks{p['blocks']}"] = _graph_ms(torch, lambda: _launch(x, p, constants),
                                                            20)
    return {"shape": [B, L, H_, W_, C], "plan": chosen, "device_ms": times}


def _check_ssim(torch, gen):
    from vct_torch.ops import _build
    from vct_torch.ops.ssim import _constants, _launch, plan, ssim_pair_scores, ssim_pair_scores_ref

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
        (3, 5, 3, 3, 3),     # the smallest frame
        (3, 13, 7, 5, 1),    # odd H*W*C
        (1, 30, 3, 80, 3),   # one output row (H=3) in every band
        (2, 24, 19, 40, 3),  # L-1 and H-2 prime: uneven chunks and bands
        (2, 9, 12, 132, 1),  # row lengths off 16 bytes: the byte path
        (2, 9, 12, 258, 1),
        (2, 9, 12, 5, 1),
        (1, 6, 9, 128, 3),   # more columns than a block's threads
        (1, 9, 14, 320, 3),  # decoded widths, as served frames arrive: UCF50's
        (1, 4, 6, 3840, 3),  # 320, 4K's 3840 and (byte path) 240p's 426 pixels
        (1, 4, 6, 426, 3),
    ]
    cases = [(s, torch.randint(0, 256, s, dtype=torch.uint8, generator=gen).cuda(), None)
             for s in shapes]
    flat = torch.randint(0, 256, (1 + 2 * 10 * 8 * 8 * 3,), dtype=torch.uint8, generator=gen).cuda()
    cases.append(("unaligned 2x10x8x8x3", flat[1:].view(2, 10, 8, 8, 3), None))
    frame = torch.randint(0, 256, (1, 1, H, W, 3), dtype=torch.uint8, generator=gen).cuda()
    static = frame.expand(4, 30, H, W, 3).contiguous()
    cases.append(("all-equal 4x30x80x80x3", static, None))
    # Forced plans where chunks and bands do not divide the clip, on both paths.
    for K, R in ((1, 1), (3, 5), (7, 17)):
        for shape in ((2, 24, 19, 40, 3), (1, 11, 18, 43, 3)):
            x = torch.randint(0, 256, shape, dtype=torch.uint8, generator=gen).cuda()
            cases.append((f"{shape} K={K} R={R}", x, plan(*shape, K, R)))
    err, equal = 0.0, 0
    for name, x, forced in cases:
        _build.fill_shared_memory(float("nan"))  # a stale read of shared memory fails the check
        got = ssim_pair_scores(x) if forced is None else _launch(x, forced, _constants(3, 255.0))
        want = ssim_pair_scores_ref(x)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, atol=2e-6, rtol=0, msg=f"ssim_pair_scores {name}")
        err = max(err, (got - want).abs().max().item())
        equal += int(torch.equal(got, want))
        p = plan(*x.shape) if forced is None else forced
        print(f"  K4 {name}: plan K={p['chunk_pairs']} R={p['band_rows']} "
              f"threads={p['threads']} blocks={p['blocks']}")
    if equal != len(cases):
        raise AssertionError(f"ssim_pair_scores: bit-equal in {equal} of {len(cases)} only")
    _build.fill_shared_memory(float("nan"))
    if not torch.equal(ssim_pair_scores(static), torch.ones((4, 29), device=static.device)):
        raise AssertionError("ssim_pair_scores: all-equal frames do not score exactly 1.0")
    # A CUDA graph replays the launch with its (clip, chunk) counters as the
    # last replay left them: every replay must give the same scores.
    x = cases[1][1]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ssim_pair_scores(x)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y = ssim_pair_scores(x)
    replays = []
    for _ in range(3):
        graph.replay()
        replays.append(y.clone())
    torch.cuda.synchronize()
    if not all(torch.equal(r, ssim_pair_scores_ref(x)) for r in replays):
        raise AssertionError("ssim_pair_scores: CUDA graph replays differ from the plain version")
    print(f"K4 ssim_pair_scores: {len(cases)} shapes and plans agree within 2e-6, bit-equal in "
          f"{equal} of {len(cases)}, each after a NaN fill of shared memory; all-equal frames "
          f"score exactly 1.0; 3 graph replays bit-equal; max abs err {err}")
    return err


IMAGENET_MEAN, IMAGENET_STD = [0.485, 0.456, 0.406], [0.229, 0.224, 0.225]


def _check_normalize(torch, gen):
    from vct_torch.ops.preprocess import normalize_frames, normalize_frames_ref

    shapes = [(32, T, H, W, 3), (3, 7, 5, 3), (2, 5, 9, 1)]  # the bench clips, odd size, C=1
    cases = [(s, torch.randint(0, 256, s, dtype=torch.uint8, generator=gen).cuda()) for s in shapes]
    flat = torch.randint(0, 256, (1 + 4 * 8 * 8 * 3,), dtype=torch.uint8, generator=gen).cuda()
    cases.append(("unaligned 4x8x8x3", flat[1:].view(4, 8, 8, 3)))
    err = 0.0
    for name, x in cases:
        C = x.shape[-1]
        for mean, std in ((None, None), (IMAGENET_MEAN[:C], IMAGENET_STD[:C])):
            got, want = normalize_frames(x, mean, std), normalize_frames_ref(x, mean, std)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"normalize_frames {name} mean={mean}: not bit-exact, max abs "
                                     f"err {(got - want).abs().max().item()}")
            err = max(err, (got - want).abs().max().item())
    print(f"K6 normalize_frames: {len(cases)} shapes x (identity, ImageNet) bit-exact; "
          f"max abs err {err}")
    return err


def _scan_inputs(torch, gen, B, L, D, N):
    u = torch.randn(B, L, D, generator=gen)
    delta = torch.rand(B, L, D, generator=gen) * 0.5
    A = -torch.rand(D, N, generator=gen) - 0.1
    Bm = torch.randn(B, L, N, generator=gen)
    Cm = torch.randn(B, L, N, generator=gen)
    return [t.cuda() for t in (u, delta, A, Bm, Cm)]


# K3 shapes (B, L, D, N): the bench-shaped batch, a served request
# (batch_size 4), VideoMamba's width, the sweep's top (rnn_input_size 16:
# N = hidden = 64), every state size the LRCN's hidden_size can give it
# (N = 1 to 100, at the deployed widths of a request), and L = 1.
SCAN_SHAPES = ([(32, T, 16, 32), (4, T, 16, 32), (2, 256, 2048, 16), (32, T, 32, 64)]
               + [(4, T, 16, n) for n in (1, 8, 12, 24, 33, 64, 100)] + [(4, 1, 16, 32)])
# K3 shapes timed under other plans: the first four, and N=100 (four warps a channel).
SCAN_PLAN_SHAPES = SCAN_SHAPES[:4] + [(4, T, 16, 100)]


def _check_selective_scan(torch, gen):
    from vct_torch.ops._build import fill_shared_memory
    from vct_torch.ops.selective_scan import plan, selective_scan, selective_scan_ref

    err = 0.0
    for dims in SCAN_SHAPES:
        args = _scan_inputs(torch, gen, *dims)
        for reverse in (False, True):
            fill_shared_memory(float("nan"))  # a stale read of shared memory fails the check
            got = selective_scan(*args, reverse=reverse)
            want = selective_scan_ref(*args, reverse=reverse)
            torch.cuda.synchronize()
            torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
            err = max(err, (got - want).abs().max().item())
        B, L, D, N = dims
        print(f"  selective_scan B={B} L={L} D={D} N={N}: plan {plan(B, D, N)}, "
              f"max abs err {(got - want).abs().max().item()}")
    print(f"K3 selective_scan: {len(SCAN_SHAPES)} shapes, fwd and reverse, agree after a NaN "
          f"fill of shared memory; max abs err {err}")
    return err


def _rnn_inputs(torch, gen, n_gates, B, T, Hd, L):
    """Gate inputs and weights drawn like the model's: U(-1/sqrt(H), 1/sqrt(H))."""
    k, GH = Hd ** -0.5, n_gates * Hd
    xp = torch.randn(B, T, GH, generator=gen)
    ws = [(torch.rand(s, generator=gen) * 2 - 1) * k
          for s in ((L, Hd, GH), (L, GH), (L - 1, Hd, GH), (L - 1, GH))]
    return [t.cuda() for t in [xp] + ws]


def _check_rnn(torch, gen):
    from vct_torch.ops import lstm as ops
    from vct_torch.ops._build import fill_shared_memory

    def stale(op, *args):
        """``op`` launched after NaN was left in every SM's shared memory."""
        fill_shared_memory(float("nan"))
        return op(*args)

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    errs = dict.fromkeys(("lstm_stack", "gru_stack", "lstm_scan", "gru_scan"), 0.0)
    # (B, T, H, L): the bench stack, a served request, one video; the
    # register design's edges (H=64 at L=4, the largest plan; the default
    # width H=32 at T=60; T=130 over three staged chunks; H=16, the widest
    # LSTM with two k-slices per gate column); the "columns"
    # design's shared-memory plans (H=65, its first shape; H=96: W_hh
    # staged, W_ih read through L2; H=256: both weights through L2; H=512,
    # T=128: the previous layer's outputs through L2 too); an odd H, T=1.
    shapes = [(32, 40, 56, 4), (4, 40, 56, 4), (1, 40, 56, 4), (2, 16, 64, 4), (32, 60, 32, 3),
              (2, 130, 17, 3), (3, 40, 16, 4), (2, 16, 65, 2), (2, 16, 96, 2), (2, 16, 256, 2),
              (1, 128, 512, 2), (3, 7, 5, 3), (2, 1, 56, 2)]
    for cell, n_gates in (("lstm", 4), ("gru", 3)):
        stack, scan = getattr(ops, f"{cell}_stack"), getattr(ops, f"{cell}_scan")
        scan_ref = getattr(ops, f"{cell}_scan_ref")
        for B, T_, Hd, L in shapes:
            xp, w_hh, b_hh, w_ih, b_ih = _rnn_inputs(torch, gen, n_gates, B, T_, Hd, L)
            cases = [
                (f"{cell}_stack", L, stale(stack, xp, w_hh, b_hh, w_ih, b_ih),
                 ops.stack_ref(xp, w_hh, b_hh, w_ih, b_ih)),
                (f"{cell}_scan", 1, stale(scan, xp, w_hh[0], b_hh[0]),
                 scan_ref(xp, w_hh[0], b_hh[0])),
            ]
            if (B, T_, Hd) == (32, 40, 56):  # K5 through the flip, as the reverse direction runs
                flip = torch.flip(xp, dims=(1,))
                cases.append((f"{cell}_scan", 1,
                              torch.flip(stale(scan, flip, w_hh[1], b_hh[1]), dims=(1,)),
                              torch.flip(scan_ref(flip, w_hh[1], b_hh[1]), dims=(1,))))
            torch.cuda.synchronize()
            for name, layers, got, want in cases:
                design = ops.design(T_, Hd, layers, n_gates)
                if design != ("registers" if Hd <= 64 else "columns"):
                    raise AssertionError(f"{name} H={Hd}: took the {design} design")
                torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
                err = (got - want).abs().max().item()
                errs[name] = max(errs[name], err)
                shown = f" L={layers}" if name.endswith("stack") else ""
                print(f"  {name} B={B} T={T_} H={Hd}{shown}: design {design}, max abs err {err}")
    print(f"K2/K5 lstm/gru stack and scan: {len(shapes)} shapes each agree; max abs err {errs}")
    return errs


# Backward checks: each gradient within BWD_RTOL of its largest magnitude of
# autograd through the plain version (f32, other summation orders).
BWD_RTOL = 1e-5
# K2 backward shapes (B, T, H, L): the bench stack, a request, the default
# width; the register design's edges H = 1, 5, 17 (odd), 64 (its widest
# plan) and T = 130 (three chunks); H = 65 and 256 ("columns", W_hh read
# through L2 at 256).
BWD_LONG_T = 130
# K3 backward shapes (B, L, D, N): the deployed step, VideoMamba's width,
# N = 1, 24, 64, 100 at the deployed widths of a request, L = 130 (three
# chunks: a first pass keeps h at the later chunks' starts) and N = 300 (two
# state tiles). The deployed step and L = 130 run in both directions.
BWD_SCAN_SHAPES = ([(32, T, 16, 32), (2, 256, 2048, 16)] + [(4, T, 16, n) for n in (1, 24, 64, 100)]
                   + [(4, BWD_LONG_T, 16, 32), (4, T, 16, 300)])
BWD_SCAN_BOTH_WAYS = (BWD_SCAN_SHAPES[0], (4, BWD_LONG_T, 16, 32))
# VideoMamba's shape (n_state 16, d_inner 2048 at L = 256), timed beside the
# deployed step.
VIDEOMAMBA_SCAN = (2, 256, 2048, 16)
BWD_RNN_SHAPES = [(32, 40, 56, 4), (4, 40, 56, 4), (32, 60, 32, 3), (3, 7, 5, 3), (2, 20, 17, 3),
                  (2, 16, 1, 2), (2, 16, 64, 4), (2, BWD_LONG_T, 17, 3), (2, 16, 65, 2),
                  (2, 16, 256, 2)]
# The backward entry points and the vct custom_vjp backward each replaces
# (plain JAX there, no Pallas kernel).
BWD_KERNELS = {
    "selective_scan_bwd": ("vct_torch/csrc/selective_scan_bwd.cu",
                           "vct/ops/selective_scan_pallas.py:102"),
    "lstm_stack_bwd": ("vct_torch/csrc/lstm_bwd.cu", "vct/ops/lstm_pallas.py:327"),
    "gru_stack_bwd": ("vct_torch/csrc/lstm_bwd.cu", "vct/ops/lstm_pallas.py:327"),
    "lstm_scan_bwd": ("vct_torch/csrc/lstm_bwd.cu", "vct/ops/lstm_pallas.py:343"),
    "gru_scan_bwd": ("vct_torch/csrc/lstm_bwd.cu", "vct/ops/lstm_pallas.py:343"),
}


def _bwd_spills(log: str) -> dict:
    """Spill-store bytes ptxas reports for each register-design instance of
    the backward (``rnn_bwd_reg_kernel<G, KU, S, NQ>``): the library builds
    only those the design takes. Raises if the log holds none."""
    found = {}
    for line in _ptxas_lines(log):
        m = re.search(r"rnn_bwd_reg_kernelILi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)E", line)
        if m:
            found[tuple(map(int, m.groups()))] = int(re.search(r"(\d+) bytes spill stores",
                                                               line).group(1))
    if not found:
        raise AssertionError("no ptxas line for a backward register instance")
    return found


def _grads_close(torch, what, got, want, names) -> tuple[float, float]:
    """Each gradient within BWD_RTOL of its largest magnitude; returns the
    largest error over that magnitude and the largest absolute error."""
    worst, worst_abs = 0.0, 0.0
    for name, g, w in zip(names, got, want):
        if g is None:
            raise AssertionError(f"{what} d{name}: no gradient")
        scale, err = w.abs().max().item(), (g - w).abs().max().item()
        if not (err <= BWD_RTOL * scale if scale > 0 else err == 0):
            raise AssertionError(f"{what} d{name}: max abs err {err} against {BWD_RTOL} x {scale}")
        worst, worst_abs = max(worst, err / scale if scale > 0 else 0.0), max(worst_abs, err)
    return worst, worst_abs


def _replay_equal(torch, fn) -> bool:
    """``fn`` (returning a tuple of tensors) run twice and replayed once from
    a CUDA graph, each launch after a NaN fill: all bit-equal."""
    from vct_torch.ops._build import fill_shared_memory

    runs = []
    for _ in range(2):
        fill_shared_memory(float("nan"))
        runs.append([t.clone() for t in fn()])
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    fill_shared_memory(float("nan"))
    graph.replay()
    torch.cuda.synchronize()
    runs.append([t.clone() for t in out])
    return all(torch.equal(a, b) for run in runs[1:] for a, b in zip(runs[0], run))


def _check_backward(torch, gen) -> dict:
    """Every backward kernel against autograd through its plain version,
    each launch just after NaN was left in every SM's shared memory; two
    runs and a graph replay bit-equal. Returns the largest relative errors."""
    from vct_torch.ops import lstm as ops
    from vct_torch.ops import selective_scan as k3
    from vct_torch.ops._build import fill_shared_memory

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    errs = {n: (0.0, 0.0) for n in BWD_KERNELS}

    def note(name, err):
        errs[name] = tuple(max(a, b) for a, b in zip(errs[name], err))
        return err[0]

    for dims in BWD_SCAN_SHAPES:
        args = _scan_inputs(torch, gen, *dims)
        gy = torch.randn(dims[:3], generator=gen).cuda()
        print(f"  selective_scan_bwd B,L,D,N={dims}: plan {k3.bwd_plan(*dims)}")
        for reverse in ((False, True) if dims in BWD_SCAN_BOTH_WAYS else (False,)):
            leaves = [a.clone().requires_grad_(True) for a in args]
            y = k3.selective_scan(*leaves, reverse=reverse)
            fill_shared_memory(float("nan"))
            got = torch.autograd.grad(y, leaves, gy)
            want = k3.selective_scan_bwd_ref(*args, gy, reverse=reverse)
            torch.cuda.synchronize()
            err = note("selective_scan_bwd", _grads_close(
                torch, f"selective_scan_bwd {dims} reverse={reverse}", got, want,
                ("u", "delta", "A", "B", "C")))
            print(f"  selective_scan_bwd B,L,D,N={dims} reverse={reverse}: max err / max |grad| "
                  f"{err}")
        if dims == BWD_SCAN_SHAPES[0]:
            if not _replay_equal(torch, lambda: k3.selective_scan_bwd(*args, gy)):
                raise AssertionError("selective_scan_bwd: runs or graph replay not bit-equal")

    def stale(fn):
        def wrapped(*a):
            fill_shared_memory(float("nan"))
            return fn(*a)
        return wrapped

    with mock.patch.object(ops, "_layer_bwd", stale(ops._layer_bwd)):
        for cell, n_gates in (("lstm", 4), ("gru", 3)):
            for B, T_, Hd, L in BWD_RNN_SHAPES:
                args = _rnn_inputs(torch, gen, n_gates, B, T_, Hd, L)
                gy = torch.randn(B, T_, Hd, generator=gen).cuda()
                leaves = [a.clone().requires_grad_(True) for a in args]
                got = torch.autograd.grad(getattr(ops, f"{cell}_stack")(*leaves), leaves, gy)
                want = ops.stack_bwd_ref(*args, gy)
                err = note(f"{cell}_stack_bwd", _grads_close(
                    torch, f"{cell}_stack_bwd {(B, T_, Hd, L)}", got, want,
                    ("xp0", "w_hh", "b_hh", "w_ih", "b_ih")))
                design = ops.bwd_design(T_, Hd, n_gates)
                if design != ("registers" if Hd <= 64 else "columns"):
                    raise AssertionError(f"{cell}_stack_bwd H={Hd}: took the {design} design")
                print(f"  {cell}_stack_bwd B,T,H,L={(B, T_, Hd, L)}: design {design}, "
                      f"max err / max |grad| {err}")
                if (B, T_, Hd) == (32, 40, 56):
                    y, hs, _ = ops._launch(f"{cell}_stack", n_gates, *args, save=True)
                    bwd = getattr(ops, f"{cell}_stack_bwd")
                    if not _replay_equal(torch, lambda: bwd(*args, hs, y, gy)):
                        raise AssertionError(f"{cell}_stack_bwd: runs or graph replay not "
                                             f"bit-equal")
                    # K5, both directions (the reverse one through the time flip)
                    for flip in (False, True):
                        xp = torch.flip(args[0], dims=(1,)) if flip else args[0]
                        leaves = [t.clone().requires_grad_(True) for t in (xp, args[1][0],
                                                                            args[2][0])]
                        got = torch.autograd.grad(getattr(ops, f"{cell}_scan")(*leaves), leaves,
                                                  gy)
                        want = ops.scan_bwd_ref(xp, args[1][0], args[2][0], gy)
                        err = note(f"{cell}_scan_bwd", _grads_close(
                            torch, f"{cell}_scan_bwd flip={flip}", got, want,
                            ("xp", "w_hh", "b_hh")))
                        print(f"  {cell}_scan_bwd B,T,H=(32, 40, 56) flip={flip}: max err / "
                              f"max |grad| {err}")
                    y1, _, _ = ops._launch(f"{cell}_scan", n_gates, args[0], args[1][0], args[2][0])
                    sbwd = getattr(ops, f"{cell}_scan_bwd")
                    if not _replay_equal(torch, lambda: sbwd(args[0], args[1][0], args[2][0], y1,
                                                             gy)):
                        raise AssertionError(f"{cell}_scan_bwd: runs or graph replay not bit-equal")
    print(f"backward kernels: K3 at {len(BWD_SCAN_SHAPES)} shapes, K2 at {len(BWD_RNN_SHAPES)} "
          f"shapes a cell, K5 both directions, each after a NaN fill of shared memory, within "
          f"{BWD_RTOL} of each gradient's largest magnitude; two runs and a graph replay "
          f"bit-equal; largest (err / max |grad|, abs err) {errs}")
    return errs


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
    """Switch the temporal head between the kernels ("pallas") and their
    plain versions ("scan")."""
    from vct_torch.models.recurrent import GRU, LSTM
    from vct_torch.models.ssm import ParallelMamba

    for m in model.modules():
        if isinstance(m, (ParallelMamba, LSTM, GRU)):
            m.scan_impl = impl


def _check_served(results, names):
    if [r["video_name"] for r in results] != names:
        raise AssertionError("served results do not match the requests")
    for r in results:
        scores = np.asarray(r["scores"])
        if not (np.isfinite(scores).all() and abs(scores.sum() - 1.0) < 1e-5):
            raise AssertionError(f"bad probabilities for {r['video_name']}: {scores}")


def _selection_gaps(torch, preprocess, raw, lens, seq_len, method, rows):
    """Print, for each clip in ``rows``, the score gap at the selection
    boundary under the kernel and under the plain scorer."""
    from vct_torch.ops.pair_scores import pair_scores_ref
    from vct_torch.ops.ssim import ssim_pair_scores_ref

    if method == "ssim":
        scorers = {"kernel": lambda r: 1.0 - preprocess.ssim_pair_scores(r),
                   "plain": lambda r: 1.0 - ssim_pair_scores_ref(r)}
    else:
        scorers = {"kernel": lambda r: preprocess.pair_scores(r, method),
                   "plain": lambda r: pair_scores_ref(r, method)}
    k = seq_len - 1 if method == "ssim" else seq_len  # transitions kept
    t = torch.arange(raw.shape[1] - 1, device=raw.device)[None, :]
    for name, score in scorers.items():
        s = torch.where(t < (lens - 1)[:, None], score(raw), float("-inf"))
        top = torch.sort(s, dim=-1, descending=True).values
        for b in rows:
            gap = (top[b, k - 1] - top[b, k]).item()
            print(f"  clip {b} {name}: score gap at the boundary {gap}")


def _bench_and_hold(torch, model, cfg32, seq_len, gpu, label, seed, method="sad"):
    """Time a bench-shaped step (B=32, raw L=2T, ragged lengths, ``method``
    selection, forward) as clips/s; hold the kernel path against the plain
    path, and an f32 copy of the model on the card against the CPU."""
    import vct_torch.data.preprocess as preprocess
    from vct_torch.models import build_model
    from vct_torch.ops.pair_scores import pair_scores_ref
    from vct_torch.ops.ssim import ssim_pair_scores_ref

    rng = np.random.RandomState(seed)
    raw = torch.from_numpy(rng.randint(0, 256, (32, 2 * seq_len, H, W, 3), dtype=np.uint8)).cuda()
    lens = torch.from_numpy(rng.randint(seq_len + 1, 2 * seq_len + 1, size=32)).cuda()

    def sample():
        return preprocess.device_sample_clips(raw, seq_len, method=method, lengths=lens)

    torch.backends.cudnn.deterministic = False
    with torch.inference_mode():
        x = sample()
        feats = model(x, features_only=True)
        step_ms = _events_ms(torch, lambda: model(sample()), iters=10)
        sample_ms = _events_ms(torch, sample, iters=10)
        forward_ms = _events_ms(torch, lambda: model(x), iters=10)
        backbone_ms = _events_ms(torch, lambda: model(x, features_only=True), iters=10)
        head_ms = _events_ms(torch, lambda: model(feats, from_features=True), iters=10)
    print(json.dumps({
        "config": label, "serving_clips_per_s": 32 * 1e3 / step_ms, "batch": 32,
        "sampling": method,
        "raw_len": 2 * seq_len, "T": seq_len, "ms_per_batch": step_ms, "sampling_ms": sample_ms,
        "forward_ms": forward_ms, "backbone_ms": backbone_ms, "head_ms": head_ms, "gpu": gpu,
    }))

    # --- kernel path vs the same path with the plain versions ------------
    scorer = {"sad": ("pair_scores", pair_scores_ref),
              "ssim": ("ssim_pair_scores", ssim_pair_scores_ref)}[method]
    torch.backends.cudnn.deterministic = True  # same conv algorithms on both paths
    with torch.inference_mode():
        idx_k = preprocess.sample_indices(raw, seq_len, method, lens)
        logits_k = model(sample())
        _set_scan_impl(model, "scan")
        with mock.patch.object(preprocess, *scorer):
            idx_p = preprocess.sample_indices(raw, seq_len, method, lens)
            logits_p = model(sample())
        _set_scan_impl(model, "pallas")
    if not torch.equal(idx_k, idx_p):
        rows = sorted({int(b) for b in (idx_k != idx_p).any(dim=1).nonzero()[:, 0]})
        with torch.inference_mode():
            _selection_gaps(torch, preprocess, raw, lens, seq_len, method, rows)
        raise AssertionError(f"{label}: kernel and plain {method} selection picked different "
                             f"frames in clips {rows}")
    torch.testing.assert_close(logits_k, logits_p, atol=1e-4, rtol=1e-4)
    print(f"{label}: kernel path == plain path: frame indices equal, logits max abs err "
          f"{(logits_k - logits_p).abs().max().item()}")
    torch.backends.cudnn.deterministic = False

    # --- the card against the CPU, f32, same seed -------------------------
    with torch.inference_mode():
        on_card = build_model(cfg32, seq_len, seed=0)(sample()[:2]).cpu()
        x_cpu = preprocess.device_sample_clips(raw[:2].cpu(), seq_len, method=method,
                                               lengths=lens[:2].cpu())
        on_cpu = build_model(cfg32, seq_len, device="cpu", seed=0)(x_cpu)
    torch.testing.assert_close(on_card, on_cpu, atol=1e-3, rtol=1e-3)
    print(f"{label}: f32 card vs CPU logits max abs err {(on_card - on_cpu).abs().max().item()}")


def _serve_deployed(torch, gpu, model, samplings, label):
    """The deployed model serves three requests of four decoded videos each,
    request r with ``samplings[r]``; the kernels' launch counts are read
    around exactly that run. Then the bench-shaped step is timed and held."""
    from vct_torch.core.config import ModelConfig
    from vct_torch.ops.pair_scores import pair_scores
    from vct_torch.ops.preprocess import normalize_frames
    from vct_torch.ops.selective_scan import selective_scan
    from vct_torch.ops.ssim import ssim_pair_scores
    from vct_torch.serve.deployment import (_DEVICE_METHODS, classify_and_display,
                                            sample_decoded_clips)

    counters = {"pair_scores": pair_scores, "ssim_pair_scores": ssim_pair_scores,
                "selective_scan": selective_scan, "normalize_frames": normalize_frames}
    method = _DEVICE_METHODS[samplings[0]]
    class_names = [f"class_{i}" for i in range(ModelConfig(**DEPLOYED).num_classes)]
    lengths = [40, 75, 121, 200, 60, 100, 150, 55, 120, 61, 180, 90]
    videos = _synthetic_videos(lengths, seed=0)
    names = [f"@user{i}_video_{1000 + i}.mp4" for i in range(len(videos))]
    for fn in counters.values():
        fn.launches = 0
    results = []
    for r, sampling in enumerate(samplings):
        batch = slice(4 * r, 4 * r + 4)
        clips = sample_decoded_clips(videos[batch], sampling, T)
        results += classify_and_display(model, clips, names[batch], class_names, batch_size=4)
    torch.cuda.synchronize()
    launches = {n: fn.launches for n, fn in counters.items()}
    want = dict.fromkeys(counters, 0)
    want["ssim_pair_scores" if method == "ssim" else "pair_scores"] = sum(n > T for n in lengths)
    want["selective_scan"] = len(samplings) * DEPLOYED["rnn_layer"]
    print(f"{label} path ({', '.join(samplings)}) launches {launches} (expected {want})")
    if launches != want:
        raise AssertionError(f"{label}: kernel launches {launches} != expected {want}")
    _check_served(results, names)
    _bench_and_hold(torch, model, ModelConfig(**DEPLOYED), T, gpu, label, seed=1, method=method)
    return launches


def _recurrent_path(torch, gpu):
    """Four LSTM/GRU heads at the UCF50 geometry, one request each."""
    from vct_torch.core.config import ModelConfig
    from vct_torch.models import build_model
    from vct_torch.ops import lstm as rnn_ops
    from vct_torch.ops.pair_scores import pair_scores
    from vct_torch.serve.deployment import classify_and_display, sample_decoded_clips

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    from vct_torch.ops.preprocess import normalize_frames
    from vct_torch.ops.ssim import ssim_pair_scores

    counters = {"pair_scores": pair_scores, "ssim_pair_scores": ssim_pair_scores,
                "normalize_frames": normalize_frames,
                **{n: getattr(rnn_ops, n) for n in RNN_KERNELS}}
    lengths = [30, 75, 121, 200]
    videos = _synthetic_videos(lengths, seed=2)
    names = [f"@user{i}_video_{2000 + i}.mp4" for i in range(len(videos))]
    totals = dict.fromkeys(counters, 0)
    for rnn_type, bidirectional in (("lstm", False), ("gru", False), ("lstm", True), ("gru", True)):
        cfg = ModelConfig(**UCF50, rnn_type=rnn_type, bidirectional=bidirectional,
                          compute_dtype="bfloat16")
        model = build_model(cfg, T_UCF50, seed=0)
        for fn in counters.values():
            fn.launches = 0
        clips = sample_decoded_clips(videos, "sad", T_UCF50)
        results = classify_and_display(model, clips, names,
                                       [f"class_{i}" for i in range(cfg.num_classes)], batch_size=4)
        torch.cuda.synchronize()
        launches = {n: fn.launches for n, fn in counters.items()}
        want = dict.fromkeys(counters, 0)
        want["pair_scores"] = sum(n > T_UCF50 for n in lengths)
        if bidirectional:  # K5 per layer and direction
            want[f"{rnn_type}_scan"] = 2 * cfg.rnn_layer
        else:  # the whole stack in one K2 launch
            want[f"{rnn_type}_stack"] = 1
        head = f"{rnn_type} {'bidir' if bidirectional else 'uni'}"
        print(f"{head} path launches {launches} (expected {want})")
        if launches != want:
            raise AssertionError(f"{head}: kernel launches {launches} != expected {want}")
        _check_served(results, names)
        totals = {n: totals[n] + launches[n] for n in totals}
        del model
    model = build_model(ModelConfig(**UCF50, rnn_type="lstm", compute_dtype="bfloat16"),
                        T_UCF50, seed=0)
    _bench_and_hold(torch, model, ModelConfig(**UCF50, rnn_type="lstm"), T_UCF50, gpu,
                    "ucf50_lstm", seed=3)
    return totals


# The training path: both served configurations at full width, trained at
# the bench batch (bench.py's train mode) on synthetic clips; 40 samples
# split 32 / 8: one bench batch a step.
TRAIN_CONFIGS = {"deployed_mamba": (DEPLOYED, T), "ucf50_lstm": ({**UCF50, "rnn_type": "lstm"},
                                                                 T_UCF50)}
TRAIN_BATCH, TRAIN_SAMPLES, TRAIN_EPOCHS = 32, 40, 2
# Relative agreement of the kernel and plain training paths over 5 Adam steps.
TRAIN_RTOL = 1e-4


def _train_counters():
    from vct_torch.ops import lstm as rnn_ops
    from vct_torch.ops import selective_scan as k3

    return {"selective_scan": k3.selective_scan, "selective_scan_bwd": k3.selective_scan_bwd,
            **{n: getattr(rnn_ops, n) for n in RNN_KERNELS},
            **{n: getattr(rnn_ops, n) for n in BWD_KERNELS if n != "selective_scan_bwd"}}


def _expected_train_launches(model: dict, forwards: int, backwards: int) -> dict:
    """Kernel launches of ``forwards`` forward passes and ``backwards``
    backward passes of the head: the Mamba head one K3 forward and one K3
    backward a block; the unidirectional LSTM/GRU stack one K2 forward and
    one backward launch a layer; a bidirectional one K5 forward and backward
    a layer and direction."""
    want = dict.fromkeys(_train_counters(), 0)
    layers, rnn = model["rnn_layer"], model["rnn_type"]
    if rnn == "mamba":
        want["selective_scan"] = forwards * layers
        want["selective_scan_bwd"] = backwards * layers
    elif model.get("bidirectional"):  # K5 a layer and direction, both ways
        want[f"{rnn}_scan"] = forwards * 2 * layers
        want[f"{rnn}_scan_bwd"] = backwards * 2 * layers
    else:
        want[f"{rnn}_stack"] = forwards
        want[f"{rnn}_stack_bwd"] = backwards * layers
    return want


def _train_cli(torch, label, model: dict, seq_len: int) -> dict:
    """``python -m vct_torch.train``'s main on synthetic data at full width:
    its epoch lines and metric block, checked by ``extract_metrics``, and the
    kernels' launches around exactly that run."""
    import contextlib
    import io
    import tempfile

    from vct_torch.core.metrics_contract import extract_metrics
    from vct_torch.train.__main__ import main as train_main

    argv = ["--data.synthetic", "true", "--data.synthetic_samples", str(TRAIN_SAMPLES),
            "--data.sequence_length", str(seq_len), "--train.epochs", str(TRAIN_EPOCHS),
            "--train.batch_size", str(TRAIN_BATCH), "--model.compute_dtype", "bfloat16"]
    for key, value in model.items():
        argv += [f"--model.{key}", str(value)]
    counters = _train_counters()
    with tempfile.TemporaryDirectory() as tmp:
        for fn in counters.values():
            fn.launches = 0
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = train_main(argv + ["--train.model_path", tmp])
        torch.cuda.synchronize()
        launches = {n: fn.launches for n, fn in counters.items()}
    text = out.getvalue()
    print("\n".join(f"  | {line}" for line in text.splitlines()))
    metrics = extract_metrics(text)
    epochs = sum(line.startswith("Epoch ") for line in text.splitlines())
    if rc != 0 or epochs != TRAIN_EPOCHS or "Model saved to" not in text:
        raise AssertionError(f"{label}: train main rc {rc}, {epochs} epoch lines")
    n_test = int(round(TRAIN_SAMPLES * 0.2))
    steps = TRAIN_EPOCHS * -(-(TRAIN_SAMPLES - n_test) // TRAIN_BATCH)
    want = _expected_train_launches(model, steps + -(-n_test // TRAIN_BATCH), steps)
    print(f"{label} train main: accuracy {metrics.accuracy}, trainable params "
          f"{metrics.trainable_params}; launches {launches} (expected {want})")
    if launches != want:
        raise AssertionError(f"{label}: train launches {launches} != expected {want}")
    return launches


def _train_hold_and_time(torch, gen, gpu, label, model: dict, seq_len: int) -> dict:
    """From the same weights, dropout 0, TF32 off: five Adam steps of the
    head on the same backbone features through the kernels and through the
    plain versions (``_set_scan_impl``), losses and parameters within
    TRAIN_RTOL; every trained parameter's gradient on the kernel path
    (the declared-but-unread Mamba ``D`` excepted) within BWD_RTOL of its
    largest magnitude of the plain path's; then the steady-state train step
    at the bench batch, timed by CUDA events, with its launches a step."""
    from vct_torch.core.config import Config
    from vct_torch.train.engine import Trainer

    overrides = {"data.sequence_length": str(seq_len), "train.batch_size": str(TRAIN_BATCH),
                 "model.compute_dtype": "bfloat16", "model.dropout": "0.0",
                 **{f"model.{k}": str(v) for k, v in model.items()}}
    cfg = Config().replace(**overrides)
    names = [f"class_{i}" for i in range(cfg.model.num_classes)]
    trainer = Trainer(cfg, names)
    net = trainer.model
    start = {k: v.clone() for k, v in net.state_dict().items()}
    clips = torch.rand(TRAIN_BATCH, seq_len, H, W, 3, generator=gen).cuda()
    labels = [torch.randint(0, cfg.model.num_classes, (TRAIN_BATCH,), generator=gen).cuda()
              for _ in range(5)]
    mask = torch.ones(TRAIN_BATCH, device=clips.device)
    with torch.no_grad():
        feats = net.eval()(clips, features_only=True)
    trainer._feature_mode = True
    runs = {}
    for impl in ("pallas", "scan"):
        net.load_state_dict(start)
        _set_scan_impl(net, impl)
        net.train()
        loss = trainer._loss_fn(net(feats, from_features=True), labels[0], mask)[0]
        grads = torch.autograd.grad(loss, trainer._trained, allow_unused=True)
        state = trainer.init_state()
        losses, floor = [], [torch.zeros_like(p, dtype=torch.bool) for p in trainer._trained]
        for y in labels:
            losses.append(trainer._train_step(state, feats, y, mask)[0].item())
            for f, p in zip(floor, trainer._trained):
                f |= p.grad.abs() < BWD_RTOL * p.grad.abs().max()
        runs[impl] = (grads, losses, [p.detach().clone() for p in trainer._trained], floor)
    _set_scan_impl(net, "pallas")
    names_trained = [n for n, p in net.named_parameters() if p.requires_grad]
    (g_k, l_k, p_k, f_k), (g_p, l_p, p_p, f_p) = runs["pallas"], runs["scan"]
    for n, a, b in zip(names_trained, g_k, g_p):
        if n.endswith(".mixer.D"):
            if a is not None or b is not None:
                raise AssertionError(f"{label}: {n} is declared unused, yet has a gradient")
            continue
        _grads_close(torch, f"{label} kernel-path gradient of", [a], [b], [n])
    # Parameters: each tensor's difference, in norm, within TRAIN_RTOL of its
    # norm, over the elements whose gradient stayed above BWD_RTOL of the
    # tensor's largest on both paths at every step. Below that floor the
    # two paths' gradients are f32 noise and Adam's normalised step follows
    # the noise's sign: those elements are held to the most two Adam
    # trajectories can part by, 2 lr a step.
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(l_k, l_p))
    bound = 2 * cfg.train.learning_rate * len(labels)
    param_err, raw_err, at_floor, n_elems = 0.0, 0.0, 0, 0
    for n, a, b, fa, fb in zip(names_trained, p_k, p_p, f_k, f_p):
        floor = fa | fb
        keep = ~floor
        raw_err = max(raw_err, ((a - b).norm() / b.norm()).item())
        if keep.any():
            param_err = max(param_err, ((a - b)[keep].norm() / b[keep].norm()).item())
        if not bool(((a - b).abs()[floor] <= bound).all()):
            raise AssertionError(f"{label}: {n} moved apart beyond Adam's bound {bound}")
        at_floor, n_elems = at_floor + int(floor.sum()), n_elems + floor.numel()
    if not (loss_err <= TRAIN_RTOL and param_err <= TRAIN_RTOL):
        raise AssertionError(f"{label}: 5 Adam steps, kernel vs plain: losses rel err {loss_err}, "
                             f"parameters rel err {param_err}, over {TRAIN_RTOL}")
    print(f"{label}: every trained parameter's gradient on the kernel path within {BWD_RTOL} of "
          f"the plain path's ({len(names_trained)} tensors); 5 Adam steps, losses {l_k} "
          f"against {l_p}: largest rel err {loss_err}; parameters (norm, above the gradients' "
          f"noise floor) {param_err}, all elements {raw_err}; {at_floor} of {n_elems} elements "
          f"at the floor, within {bound}")

    # --- the steady-state train step at the bench batch ---------------------
    trainer._feature_mode = False
    net.load_state_dict(start)
    state = trainer.init_state()
    step = lambda: trainer._train_step(state, clips, labels[0], mask)  # noqa: E731
    counters = _train_counters()
    step_ms = _events_ms(torch, step, iters=5, warmup=2)
    for fn in counters.values():
        fn.launches = 0
    for _ in range(3):
        step()
    torch.cuda.synchronize()
    per_step = {n: fn.launches / 3 for n, fn in counters.items()}
    want = _expected_train_launches(model, 1, 1)
    if per_step != want:
        raise AssertionError(f"{label}: launches a train step {per_step} != expected {want}")
    with torch.no_grad():
        backbone_ms = _events_ms(torch, lambda: net(clips, features_only=True), iters=5)
    trainer._feature_mode = True
    head_ms = _events_ms(torch, lambda: trainer._train_step(state, feats, labels[0], mask), iters=10)
    trainer._feature_mode = False
    breakdown = _profile_groups(torch, step, 3)
    out = {"config": label, "train_step_ms": step_ms, "train_clips_per_s": TRAIN_BATCH * 1e3 / step_ms,
           "batch": TRAIN_BATCH, "T": seq_len, "backbone_forward_ms": backbone_ms,
           "head_step_ms": head_ms, "launches_per_step": per_step,
           "expected_launches_per_step": want, "device_breakdown": breakdown, "gpu": gpu}
    print(json.dumps(out))
    del trainer, net
    torch.cuda.empty_cache()
    return out


def _profile_groups(torch, fn, steps: int) -> dict:
    """Device time a step of ``fn`` by kernel, from ``torch.profiler`` over
    ``steps`` calls: the twelve largest, their total, and the step's wall
    time (busy share = device / wall); None where the profiler records no
    device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / steps
    rows = []
    for e in prof.key_averages():  # the kernels themselves, not the ops that launched them
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev = getattr(e, "self_device_time_total", None)
        if dev is None:
            dev = getattr(e, "self_cuda_time_total", 0.0)
        if dev:
            rows.append((e.key, dev / 1e3 / steps))
    if not rows:
        return {"device_ms": None, "wall_ms": wall}
    rows.sort(key=lambda r: -r[1])
    total = sum(ms for _, ms in rows)
    return {"device_ms": total, "wall_ms": wall, "busy_share": total / wall,
            "top": [[k[:80], ms] for k, ms in rows[:12]]}


def _train_heads(torch, gen) -> dict:
    """One train step at the bench batch for each other head of the UCF50
    geometry (GRU, and LSTM and GRU bidirectional), launch counts read
    around it: K2's GRU backward and K5's backward on a training path."""
    from vct_torch.core.config import Config
    from vct_torch.train.engine import Trainer

    counters = _train_counters()
    totals = dict.fromkeys(counters, 0)
    ucf50 = {**UCF50, "compute_dtype": "bfloat16"}
    for rnn_type, bidirectional in (("gru", False), ("lstm", True), ("gru", True)):
        model = {**ucf50, "rnn_type": rnn_type, "bidirectional": bidirectional}
        cfg = Config().replace(**{"data.sequence_length": str(T_UCF50),
                                  **{f"model.{k}": str(v) for k, v in model.items()}})
        trainer = Trainer(cfg, [f"class_{i}" for i in range(cfg.model.num_classes)])
        state = trainer.init_state()
        clips = torch.rand(TRAIN_BATCH, T_UCF50, H, W, 3, generator=gen).cuda()
        labels = torch.randint(0, cfg.model.num_classes, (TRAIN_BATCH,), generator=gen).cuda()
        for fn in counters.values():
            fn.launches = 0
        loss = trainer._train_step(state, clips, labels, torch.ones(TRAIN_BATCH, device="cuda"))[0]
        torch.cuda.synchronize()
        launches = {n: fn.launches for n, fn in counters.items()}
        want = _expected_train_launches(model, 1, 1)
        head = f"{rnn_type} {'bidir' if bidirectional else 'uni'}"
        print(f"{head} train step: loss {loss.item()}, launches {launches} (expected {want})")
        if launches != want or not np.isfinite(loss.item()):
            raise AssertionError(f"{head}: train step launches {launches} != expected {want}")
        totals = {n: totals[n] + launches[n] for n in totals}
        del trainer, state
    torch.cuda.empty_cache()
    return totals


def _train_path(torch, gen, gpu) -> dict:
    """Both configurations through the train CLI, the kernel/plain hold and
    the timed step, then a step of each other UCF50 head; returns the summed
    launches of the CLI runs and those steps."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    totals = dict.fromkeys(_train_counters(), 0)
    for label, (model, seq_len) in TRAIN_CONFIGS.items():
        launches = _train_cli(torch, label, model, seq_len)
        totals = {n: totals[n] + launches[n] for n in totals}
        _train_hold_and_time(torch, gen, gpu, label, model, seq_len)
    launches = _train_heads(torch, gen)
    return {n: totals[n] + launches[n] for n in totals}


# The resume phase: both configurations at full width, dropout on, and a
# learning rate (1e-11) that moves the val loss far less than the plateau's
# 1e-6: the plateau lowers the learning rate at epochs 2 and 3 by
# construction, and a run is "crashed" after epoch 1 and again after epoch 2,
# so the restored dropout generator, Adam moments, step count and lowered
# learning rate all reach the resumed run's result.
RESUME_EPOCHS = 3
RESUME_ARGS = {"model.dropout": "0.25", "train.learning_rate": "1e-11",
               "train.lr_plateau_factor": "0.5", "train.lr_plateau_patience": "1"}
# Kernel function names in a torch.profiler trace, by the launch counters
# whose launches they are.
TRACE_KERNELS = {
    "selective_scan": (("selective_scan",), ("selective_scan_kernel",)),
    "selective_scan_bwd": (("selective_scan_bwd",), ("scan_bwd_kernel",)),
    "lstm_gru": (tuple(RNN_KERNELS), ("rnn_reg_kernel", "rnn_stack_kernel")),
    "lstm_gru_bwd": (tuple(n for n in BWD_KERNELS if n != "selective_scan_bwd"),
                     ("rnn_bwd_reg_kernel", "rnn_bwd_cols_kernel")),
}


def _trace_kernel_counts(path) -> dict:
    """Device kernels of a Chrome trace (``torch.profiler``'s) by
    ``TRACE_KERNELS`` group: events of category "kernel" whose name holds
    one of the group's function names."""
    events = json.loads(Path(path).read_text())["traceEvents"]
    names = [e.get("name", "") for e in events if str(e.get("cat", "")).lower() == "kernel"]
    return {group: sum(any(k in n for k in kernels) for n in names)
            for group, (_, kernels) in TRACE_KERNELS.items()}


def _nonzero(counts: dict) -> dict:
    return {n: c for n, c in counts.items() if c}


def _counted_groups(launches: dict) -> dict:
    """Launch counters summed by ``TRACE_KERNELS`` group."""
    return {group: sum(launches.get(c, 0) for c in counters)
            for group, (counters, _) in TRACE_KERNELS.items()}


# The torchvision ResNet layouts, written out here independently of the
# porter: (block, blocks a stage), conv weights OIHW.
TORCHVISION_RESNETS = {"resnet18": ("basic", (2, 2, 2, 2)), "resnet50": ("bottleneck", (3, 4, 6, 3))}


def _torchvision_resnet_keys(name: str) -> dict:
    """torchvision's ResNet state_dict layout: key -> shape, ``fc`` included."""
    block, stages = TORCHVISION_RESNETS[name]
    keys = {"conv1.weight": (64, 3, 7, 7)}

    def bn(prefix, c):
        keys.update({f"{prefix}.weight": (c,), f"{prefix}.bias": (c,),
                     f"{prefix}.running_mean": (c,), f"{prefix}.running_var": (c,),
                     f"{prefix}.num_batches_tracked": ()})

    bn("bn1", 64)
    cin, expansion = 64, (4 if block == "bottleneck" else 1)
    for stage, (width, n) in enumerate(zip((64, 128, 256, 512), stages), start=1):
        out = width * expansion
        for b in range(n):
            p = f"layer{stage}.{b}"
            first_in = cin if b == 0 else out
            if block == "bottleneck":
                convs = [(width, first_in, 1), (width, width, 3), (out, width, 1)]
            else:
                convs = [(width, first_in, 3), (width, width, 3)]
            for i, (co, ci, k) in enumerate(convs, start=1):
                keys[f"{p}.conv{i}.weight"] = (co, ci, k, k)
                bn(f"{p}.bn{i}", co)
            if b == 0 and (stage > 1 or cin != out):
                keys[f"{p}.downsample.0.weight"] = (out, cin, 1, 1)
                bn(f"{p}.downsample.1", out)
        cin = out
    keys.update({"fc.weight": (1000, cin), "fc.bias": (1000,)})
    return keys


def _reference_lrcn_keys(model_cfg, seq_len: int) -> dict:
    """The reference LRCN's state_dict layout (``medsos_lrcn/src/models.py:
    121-186``) for ``model_cfg``: key -> shape."""
    keys = {f"cnn_backbone.{k}": s for k, s in _torchvision_resnet_keys(model_cfg.cnn_backbone).items()
            if not k.startswith("fc.")}
    f = keys["cnn_backbone.layer4.0.downsample.0.weight"][0]
    r, h, layers = model_cfg.rnn_input_size, model_cfg.resolved_hidden_size, model_cfg.rnn_layer
    for i, (fin, fout) in enumerate(((f, f // 2), (f // 2, f // 4), (f // 4, r)), start=1):
        keys.update({f"adapt{i}.weight": (fout, fin), f"adapt{i}.bias": (fout,),
                     f"bn{i}.weight": (fout,), f"bn{i}.bias": (fout,)})
    if model_cfg.rnn_type == "mamba":
        d = 2 * r  # d_inner; n_state = dt_rank = hidden
        for i in range(layers):
            m = f"rnn.{i}.mixer"
            keys.update({f"rnn.{i}.norm.weight": (r,), f"{m}.A_log": (d, h), f"{m}.D": (d,),
                         f"{m}.in_proj.weight": (2 * d, r), f"{m}.in_proj.bias": (2 * d,),
                         f"{m}.conv1d.weight": (d, 1, 3), f"{m}.conv1d.bias": (d,),
                         f"{m}.x_proj.weight": (h + 2 * h, d),
                         f"{m}.dt_proj.weight": (d, h), f"{m}.dt_proj.bias": (d,),
                         f"{m}.out_proj.weight": (r, 2 * d if model_cfg.bidirectional else d),
                         f"{m}.out_proj.bias": (r,)})
        width = r
    else:
        gh = (4 if model_cfg.rnn_type == "lstm" else 3) * h
        dirs = ("", "_reverse") if model_cfg.bidirectional else ("",)
        for layer in range(layers):
            fin = r if layer == 0 else h * len(dirs)
            for s in dirs:
                keys.update({f"rnn.weight_ih_l{layer}{s}": (gh, fin),
                             f"rnn.weight_hh_l{layer}{s}": (gh, h),
                             f"rnn.bias_ih_l{layer}{s}": (gh,), f"rnn.bias_hh_l{layer}{s}": (gh,)})
        width = h * len(dirs)
    pooled, c = width * (seq_len if model_cfg.rnn_out == "all" else 1), model_cfg.num_classes
    if model_cfg.classif_mode == "multiclass":
        for name, fin, fout in (("fc", pooled, pooled // 2), ("fca", pooled // 2, pooled // 4),
                                ("fcb", pooled // 4, c)):
            keys.update({f"{name}.weight": (fout, fin), f"{name}.bias": (fout,)})
        for name, n in (("bn0", pooled), ("bna", pooled // 2), ("bnb", pooled // 4)):
            keys.update({f"{name}.weight": (n,), f"{name}.bias": (n,)})
    else:
        for i in range(c):
            keys.update({f"fc.{i}.weight": (1, pooled), f"fc.{i}.bias": (1,)})
    return keys


def _seeded_state_dict(torch, keys: dict, seed: int) -> dict:
    """Tensors for a key -> shape layout from a numpy seed: weights of two
    or more dimensions N(0, 1/fan_in); norms' and BatchNorms' weights near
    1, running variances in [0.5, 1.5); other vectors N(0, 0.1)."""
    rng = np.random.RandomState(seed)
    out = {}
    for key, shape in keys.items():
        if key.endswith("num_batches_tracked"):
            out[key] = torch.tensor(0)
            continue
        if key.endswith("running_var"):
            v = 0.5 + rng.rand(*shape)
        elif len(shape) >= 2:
            v = rng.randn(*shape) / np.sqrt(np.prod(shape[1:]))
        elif key.endswith(".weight"):  # norms and BatchNorms
            v = 1.0 + 0.1 * rng.randn(*shape)
        else:
            v = 0.1 * rng.randn(*shape)
        out[key] = torch.from_numpy(np.asarray(v, np.float32))
    return out


def _torchvision_to_port(name: str) -> str:
    """A torchvision ResNet key's name in the port's backbone."""
    name = re.sub(r"^layer(\d)\.(\d+)\.", r"layer\1_\2.", name)
    return name.replace("downsample.0.", "downsample_conv.").replace("downsample.1.", "downsample_bn.")


def _resume_path(torch, gpu, label, model: dict, seq_len: int, tmp: Path) -> dict:
    """``python -m vct_torch.train``'s main at full width: an uninterrupted
    run of RESUME_EPOCHS epochs, then the same run crashed after epoch 1 and
    after epoch 2 and resumed to the end (``train.resume``), its last part
    with ``train.history_path``, ``train.log_every 1`` and
    ``train.profile_dir``. Holds the final parameters, the epoch losses and
    the launches of each resumed epoch equal to the uninterrupted run's, the
    trace's kernels to the launch counters of its epoch; then a fourth
    Trainer warm-starts from the checkpoint (``train.init_from``)."""
    import contextlib
    import io
    import os

    from vct_torch.core.config import Config
    from vct_torch.train import engine
    from vct_torch.train.__main__ import main as train_main
    from vct_torch.train.checkpoint import load_checkpoint

    overrides = {"data.synthetic": "true", "data.synthetic_samples": str(TRAIN_SAMPLES),
                 "data.sequence_length": str(seq_len), "train.batch_size": str(TRAIN_BATCH),
                 "model.compute_dtype": "bfloat16", **RESUME_ARGS,
                 **{f"model.{k}": str(v) for k, v in model.items()}}
    counters = _train_counters()
    epochs, saves = [], []  # launches of each epoch's train loop; (ms, MB) of each save
    real_trace, real_save = engine.device_trace, engine.save_train_state

    @contextlib.contextmanager
    def counted_trace(log_dir, device="cpu"):
        before = {n: fn.launches for n, fn in counters.items()}
        with real_trace(log_dir, device):
            yield
        epochs.append({n: fn.launches - before[n] for n, fn in counters.items()})

    def timed_save(path, *args, **kwargs):
        t0 = time.perf_counter()
        out = real_save(path, *args, **kwargs)
        saves.append(((time.perf_counter() - t0) * 1e3,
                      os.path.getsize(os.path.join(out, "train_state.pt")) / 1e6))
        return out

    def run(n_epochs, path, **extra):
        argv = [a for k, v in {**overrides, "train.epochs": str(n_epochs),
                               "train.model_path": str(path), **extra}.items()
                for a in (f"--{k}", v)]
        out = io.StringIO()
        with contextlib.redirect_stdout(out), \
                mock.patch.object(engine, "device_trace", counted_trace), \
                mock.patch.object(engine, "save_train_state", timed_save):
            rc = train_main(argv)
        if rc != 0:
            raise AssertionError(f"{label}: train main rc {rc}")
        return out.getvalue()

    t0 = time.perf_counter()
    out_u = run(RESUME_EPOCHS, tmp / "whole", **{"train.history_path": str(tmp / "whole.json")})
    whole = list(epochs)
    decays = [l for l in out_u.splitlines() if l.startswith("Reducing learning rate")]
    if len(decays) != RESUME_EPOCHS - 1:
        raise AssertionError(f"{label}: the plateau fired {len(decays)} times, not at epochs "
                             f"2..{RESUME_EPOCHS}: {decays}")
    ck = tmp / "resumed"
    epochs.clear()
    run(1, ck, **{"train.resume": "true", "train.save_model": "false"})
    out_2 = run(2, ck, **{"train.resume": "true", "train.save_model": "false"})
    out_3 = run(RESUME_EPOCHS, ck, **{"train.resume": "true", "train.log_every": "1",
                                      "train.history_path": str(tmp / "resumed.json"),
                                      "train.profile_dir": str(tmp / "trace")})
    seconds = time.perf_counter() - t0
    for out, epoch in ((out_2, 1), (out_3, 2)):
        if f"Resuming training from epoch {epoch}" not in out or decays[epoch - 1] not in out:
            raise AssertionError(f"{label}: the run resumed at epoch {epoch} did not resume, "
                                 f"or did not lower the learning rate as the whole run did")
    # (a) the resumed run against the uninterrupted one, bit for bit
    hist_u = json.loads((tmp / "whole.json").read_text())
    hist_r = json.loads((tmp / "resumed.json").read_text())
    for key in ("train_loss", "train_acc", "val_loss"):
        if hist_r[key] != hist_u[key] or len(hist_r[key]) != RESUME_EPOCHS:
            raise AssertionError(f"{label}: resumed {key} {hist_r[key]} != uninterrupted "
                                 f"{hist_u[key]}")
    final_u, final_r = load_checkpoint(str(tmp / "whole"))[0], load_checkpoint(str(ck))[0]
    differ = [k for k in final_u if not torch.equal(final_u[k], final_r[k])]
    if differ or set(final_u) != set(final_r):
        raise AssertionError(f"{label}: resumed parameters differ from the uninterrupted run's "
                             f"at {differ[:8]}")
    if epochs[1:] != whole[1:]:
        raise AssertionError(f"{label}: launches of the resumed epochs {epochs[1:]} != the "
                             f"uninterrupted run's {whole[1:]}")
    # (b) observability of the resumed run
    steps = -(-(TRAIN_SAMPLES - int(round(TRAIN_SAMPLES * 0.2))) // TRAIN_BATCH)
    step_lines = [l for l in out_3.splitlines() if l.startswith("step ")]
    if hist_r["step_times"].get("steps") != steps or len(step_lines) != steps:
        raise AssertionError(f"{label}: {len(step_lines)} step lines and step_times "
                             f"{hist_r['step_times']}, expected {steps} steps")
    traces = sorted((tmp / "trace").glob("*.pt.trace.json"))
    if len(traces) != 1:
        raise AssertionError(f"{label}: train.profile_dir holds {traces}, not one trace")
    in_trace, counted = _trace_kernel_counts(traces[0]), _counted_groups(epochs[-1])
    if in_trace != counted or not any(counted.values()):
        raise AssertionError(f"{label}: kernels in the trace {in_trace} != launch counters of "
                             f"the traced epoch {counted}")
    # (c) a warm start from the resumed run's checkpoint
    cfg = Config().replace(**overrides, **{"train.init_from": str(ck), "train.seed": "7"})
    trainer = engine.Trainer(cfg, [f"class_{i}" for i in range(cfg.model.num_classes)])
    trainer.init_state()
    warm = trainer.model.state_dict()
    differ = [k for k in final_r if not torch.equal(warm[k].cpu(), final_r[k])]
    if differ or set(warm) != set(final_r):
        raise AssertionError(f"{label}: init_from parameters differ from the checkpoint's at "
                             f"{differ[:8]}")
    del trainer, warm
    torch.cuda.empty_cache()
    out = {"config": label, "resume": "bit-equal", "epochs": RESUME_EPOCHS,
           "losses": hist_r["train_loss"], "plateau": decays,
           "launches_per_epoch": [_nonzero(e) for e in whole],
           "resumed_launches": [_nonzero(e) for e in epochs[1:]],
           "trace_kernels": in_trace, "trace_file_mb": traces[0].stat().st_size / 1e6,
           "step_lines": len(step_lines), "init_from": "bit-equal",
           "save_train_state_ms": [s[0] for s in saves],
           "train_state_mb": saves[0][1], "four_runs_s": seconds, "gpu": gpu}
    print(json.dumps(out))
    return out


def _weights_path(torch, gpu, tmp: Path) -> dict:
    """A seeded torchvision ResNet state_dict through ``model.backbone_weights``
    into the deployed model, each tensor checked against the key map written
    here; a seeded reference-LRCN state_dict of the deployed config through
    ``python -m vct_torch.tools.port_reference`` on the card and on the CPU,
    ``load_model`` on both, and one 4-video SAD request served on the card
    (launches of K1 and K3 counted), its logits within 1e-4 of the CPU's
    and its labels equal."""
    from vct_torch.core.config import Config, ModelConfig
    from vct_torch.ops.pair_scores import pair_scores
    from vct_torch.ops.selective_scan import selective_scan
    from vct_torch.serve.deployment import classify_and_display, load_model, sample_decoded_clips
    from vct_torch.tools.port_reference import main as port_main
    from vct_torch.train.engine import Trainer

    from vct_torch.device import resolve_device

    model_cfg = ModelConfig(**DEPLOYED)
    tv = _seeded_state_dict(torch, _torchvision_resnet_keys(model_cfg.cnn_backbone), seed=11)
    torch.save(tv, tmp / "backbone.pth")
    overrides = {"data.sequence_length": str(T), "model.compute_dtype": "bfloat16",
                 "model.backbone_weights": str(tmp / "backbone.pth"),
                 **{f"model.{k}": str(v) for k, v in DEPLOYED.items()}}
    cfg = Config().replace(**overrides)
    trainer = Trainer(cfg, [f"class_{i}" for i in range(cfg.model.num_classes)])
    trainer.init_state()
    ported = trainer.model.state_dict()
    for key, value in tv.items():
        if key.startswith("fc.") or key.endswith("num_batches_tracked"):
            continue
        if not torch.equal(ported[f"cnn_backbone.{_torchvision_to_port(key)}"].cpu(), value):
            raise AssertionError(f"backbone_weights: {key} was not ported as written")
    with torch.no_grad():
        clip = torch.rand(2, T, H, W, 3, device=trainer.device)
        feats = trainer.model(clip, features_only=True)
    if feats.shape[:2] != (2, T) or not bool(torch.isfinite(feats).all()):
        raise AssertionError(f"backbone_weights: features {tuple(feats.shape)} not finite")
    del trainer, ported

    ref = _seeded_state_dict(torch, _reference_lrcn_keys(model_cfg, T), seed=12)
    torch.save(ref, tmp / "reference_lrcn.pth")
    names = [f"label_{i}" for i in range(model_cfg.num_classes)]
    argv = ["--state_dict", str(tmp / "reference_lrcn.pth"), "--num_classes",
            str(model_cfg.num_classes), "--sequence_length", str(T), "--cnn_backbone",
            model_cfg.cnn_backbone, "--rnn_type", model_cfg.rnn_type, "--rnn_input_size",
            str(model_cfg.rnn_input_size), "--rnn_layer", str(model_cfg.rnn_layer),
            "--scan_impl", model_cfg.scan_impl, "--classes", ",".join(names)]
    t0 = time.perf_counter()
    if port_main(argv + ["--out", str(tmp / "ported")]) != 0:
        raise AssertionError("port_reference failed on the card")
    port_s = time.perf_counter() - t0
    if port_main(argv + ["--out", str(tmp / "ported_cpu"), "--device", "cpu"]) != 0:
        raise AssertionError("port_reference failed on the CPU")
    model, class_names, _ = load_model(str(tmp / "ported"))
    model_cpu, _, _ = load_model(str(tmp / "ported_cpu"), device="cpu")
    if class_names != names or next(model.parameters()).device.type != resolve_device().type:
        raise AssertionError(f"load_model: {class_names} on {next(model.parameters()).device}")

    lengths = [50, 90, 130, 200]
    videos = _synthetic_videos(lengths, seed=13)
    video_names = [f"@user{i}_video_{3000 + i}.mp4" for i in range(len(videos))]
    for fn in (pair_scores, selective_scan):
        fn.launches = 0
    clips = sample_decoded_clips(videos, "sad", T)
    results = classify_and_display(model, clips, video_names, class_names, batch_size=4)
    torch.cuda.synchronize()
    launches = {"pair_scores": pair_scores.launches, "selective_scan": selective_scan.launches}
    want = {"pair_scores": sum(n > T for n in lengths), "selective_scan": model_cfg.rnn_layer}
    if launches != want:
        raise AssertionError(f"load_model request: launches {launches} != expected {want}")
    _check_served(results, video_names)
    # The same frames on both (the SAD scores are exact, ties break to the
    # lower index); the card's /255 multiplies by the reciprocal, so a pixel
    # may differ by its last bit, while another frame would differ by 1/255.
    clips_cpu = sample_decoded_clips(videos, "sad", T, device="cpu")
    frame_err = (clips.cpu() - clips_cpu).abs().max().item()
    if frame_err > 1e-6:
        raise AssertionError(f"load_model request: card and CPU selected different frames "
                             f"(largest pixel difference {frame_err})")
    with torch.inference_mode():
        logits = model(clips).cpu()
        logits_cpu = model_cpu(clips_cpu)
    torch.testing.assert_close(logits, logits_cpu, atol=1e-4, rtol=1e-4)
    labels = [r["labels"][0] for r in results]
    labels_cpu = [class_names[i] for i in logits_cpu.argmax(dim=-1).tolist()]
    if labels != labels_cpu:
        raise AssertionError(f"load_model request: labels {labels} != the CPU's {labels_cpu}")
    out = {"config": "deployed_mamba", "backbone_weights": "ported as written",
           "port_reference_s": port_s, "launches": launches, "frames_max_abs_err": frame_err,
           "logits_max_abs_err": (logits - logits_cpu).abs().max().item(), "labels": labels,
           "gpu": gpu}
    print(json.dumps(out))
    del model
    torch.cuda.empty_cache()
    return out


def _resume_and_weights(torch, gpu) -> None:
    """Resume, observability and the warm start for both configurations,
    then the weight import and ``load_model``'s served request."""
    import tempfile

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        for label, (model, seq_len) in TRAIN_CONFIGS.items():
            (Path(tmp) / label).mkdir()
            _resume_path(torch, gpu, label, model, seq_len, Path(tmp) / label)
        _weights_path(torch, gpu, Path(tmp))
    print(f"resume and weights phase: {time.perf_counter() - t0:.1f} s")


def _bwd_timing(torch, gen, name, dims) -> dict:
    """One backward entry point at the main path's shape: time by events and
    from a CUDA graph, autograd through the plain version (its forward
    included), the bound and, for LSTM/GRU, cuDNN's backward with the same
    weights. cuDNN's layer 0 takes x (B, T, H) through its own W_ih, so
    the library call also forms dx and dW_ih of that projection, two
    (B*T, H) x (H, G*H)-sized products (as much as one layer's dy and dW_ih
    here) that the entry point leaves to its caller."""
    from vct_torch.ops import lstm as ops
    from vct_torch.ops import selective_scan as k3

    if name == "selective_scan_bwd":
        B, L, D, N = dims
        args = _scan_inputs(torch, gen, B, L, D, N)
        gy = torch.randn(B, L, D, generator=gen).cuda()
        fn = lambda: k3.selective_scan_bwd(*args, gy)  # noqa: E731
        plain = lambda: k3.selective_scan_bwd_ref(*args, gy)  # noqa: E731
        bound, by = _bound_ms(4 * (5 * B * L * D + 4 * B * L * N + 2 * D * N),
                              SCAN_BWD_FLOPS * B * L * D * N)
        device_ms = _graph_ms(torch, fn, 20)
        return {"shape": list(dims), "plan": k3.bwd_plan(B, L, D, N),
                "ms": _events_ms(torch, fn, 20), "device_ms": device_ms,
                "us_per_step": device_ms / L * 1e3, "kernel_launches": _kernels_a_call(torch, fn),
                "plain_ms": _events_ms(torch, plain, 3),
                "bound_ms": bound, "bound_by": by, "library_ms": None,
                "expf_bound_ms": B * L * D * N / SFU_EXP_PER_S * 1e3}
    cell, kind, _ = name.split("_")
    n_gates = 4 if cell == "lstm" else 3
    B, T_, Hd, L = dims
    L = L if kind == "stack" else 1
    GH, k = n_gates * Hd, Hd ** -0.5
    xp, w_hh, b_hh, w_ih, b_ih = _rnn_inputs(torch, gen, n_gates, B, T_, Hd, max(L, 2))
    w_hh, b_hh, w_ih, b_ih = w_hh[:L], b_hh[:L], w_ih[:L - 1], b_ih[:L - 1]
    gy = torch.randn(B, T_, Hd, generator=gen).cuda()
    if kind == "stack":
        args = (xp, w_hh, b_hh, w_ih, b_ih)
        y, hs, _ = ops._launch(f"{cell}_stack", n_gates, *args, save=True)
        fn = lambda: getattr(ops, name)(*args, hs, y, gy)  # noqa: E731
        plain = lambda: ops.stack_bwd_ref(*args, gy)  # noqa: E731
    else:
        args = (xp, w_hh[0], b_hh[0])
        y, _, _ = ops._launch(f"{cell}_scan", n_gates, *args)
        fn = lambda: getattr(ops, name)(*args, y, gy)  # noqa: E731
        plain = lambda: ops.scan_bwd_ref(*args, gy)  # noqa: E731
    # Bytes: xp0, the weights, the saved outputs and gy read, every gradient
    # written; operations: per layer the gates' recompute, dr W_hh^T and
    # dW_hh, and above layer 0 the input parts' recompute, dW_ih and dy.
    n_w = 2 * L - 1
    n_bytes = 4 * (2 * B * T_ * GH + (L + 1) * B * T_ * Hd + 2 * n_w * (Hd + 1) * GH)
    n_ops = 2 * B * T_ * Hd * GH * (3 * L + 3 * (L - 1))
    bound, by = _bound_ms(n_bytes, n_ops)
    lib = (torch.nn.LSTM if cell == "lstm" else torch.nn.GRU)(
        Hd, Hd, num_layers=L, batch_first=True).cuda()
    x = torch.randn(B, T_, Hd, generator=gen).cuda().requires_grad_(True)
    with torch.no_grad():
        for l in range(L):
            getattr(lib, f"weight_hh_l{l}").copy_(w_hh[l].t())
            getattr(lib, f"bias_hh_l{l}").copy_(b_hh[l])
            if l:
                getattr(lib, f"weight_ih_l{l}").copy_(w_ih[l - 1].t())
                getattr(lib, f"bias_ih_l{l}").copy_(b_ih[l - 1])
    out = lib(x)[0]
    inputs = [x, *lib.parameters()]
    lib_fn = lambda: torch.autograd.grad(out, inputs, gy, retain_graph=True)  # noqa: E731
    library_device_ms, via = _library_device_ms(torch, lib_fn)
    device_ms = _graph_ms(torch, fn, 20)
    return {"shape": [B, T_, Hd, L], "design": ops.bwd_design(T_, Hd, n_gates),
            "ms": _events_ms(torch, fn, 20),
            "device_ms": device_ms, "us_per_step": device_ms / (T_ * L) * 1e3,
            "plain_ms": _events_ms(torch, plain, 3, warmup=1), "bound_ms": bound, "bound_by": by,
            "library_ms": _events_ms(torch, lib_fn, 20), "library_device_ms": library_device_ms,
            "library_device_via": via, "device_busy_ms": _busy_ms(torch, fn, 20),
            "library_busy_ms": _busy_ms(torch, lib_fn, 20)}


def _bwd_rows(torch, gen, launches, errs) -> list[dict]:
    """The kernels line's backward rows at the training path's shapes: K3's
    at the deployed Mamba step, K2's and K5's at the bench stack."""
    shapes = {"selective_scan_bwd": (TRAIN_BATCH, T, 16, 32)}
    shapes.update({n: (TRAIN_BATCH, T_UCF50, 56, 4) for n in BWD_KERNELS if n != "selective_scan_bwd"})
    rows = []
    for name, (source, replaces) in BWD_KERNELS.items():
        t = _bwd_timing(torch, gen, name, shapes[name])
        rows.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                     "launches": launches[name], "max_abs_err": errs[name][1],
                     "max_err_over_max_grad": errs[name][0], **t})
    return rows


def _library_device_ms(torch, fn):
    """cuDNN's device time: its calls replayed from a CUDA graph, as for the
    kernels, or, where capture fails on the card (cuDNN's LSTM backward at
    T = 130), the time its kernels keep the card busy under
    ``torch.profiler``: the
    union of their intervals over 20 calls, per call (cuDNN's kernels may
    overlap, so their summed times would count a shared interval twice).
    Returns (ms, how)."""
    try:
        return _graph_ms(torch, fn, 20), "cuda_graph"
    except RuntimeError:
        torch.cuda.synchronize()
        return _busy_ms(torch, fn, 20), "profiler_kernel_union"


def _kernels_a_call(torch, fn, calls: int = 20) -> float:
    """Device launches (kernels, copies, sets) ``torch.profiler`` records a
    call of ``fn``: ``calls`` calls in its active window, after a warm-up
    window of as many (a window without one missed the first launches).
    Raises if it records none."""
    from torch.profiler import ProfilerActivity, profile, schedule

    counts = []
    cuda = torch.autograd.DeviceType.CUDA
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: counts.append(
                     sum(e.device_type == cuda for e in p.events()))) as prof:
        for _ in range(2):
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            prof.step()
    if not counts or not counts[0]:
        raise RuntimeError("torch.profiler recorded no device activity")
    return counts[0] / calls


def _busy_ms(torch, fn, calls: int) -> float:
    """Device time a call of ``fn``: the union of the intervals of every
    CUDA kernel, copy and set ``torch.profiler`` records over ``calls``
    calls, over ``calls``. Raises if the profiler records none."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    if not spans:
        raise RuntimeError("torch.profiler recorded no device activity")
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e3 / calls


def _rnn_timing(torch, gen, ops, cell, kind, B, T_, Hd, L, in_size=512):
    """Time one K2/K5 entry point against its plain version and cuDNN's
    ``nn.LSTM`` / ``nn.GRU`` forward on the same function: layer 0's input
    projection from x (B, T, in_size) included in the library call only."""
    n_gates = 4 if cell == "lstm" else 3
    GH, k = n_gates * Hd, Hd ** -0.5
    L = L if kind == "stack" else 1
    _, w_hh, b_hh, w_ih, b_ih = _rnn_inputs(torch, gen, n_gates, B, T_, Hd, max(L, 2))
    w_hh, b_hh, w_ih, b_ih = w_hh[:L], b_hh[:L], w_ih[:L - 1], b_ih[:L - 1]
    x = torch.randn(B, T_, in_size, generator=gen).cuda()
    w_ih0 = ((torch.rand(in_size, GH, generator=gen) * 2 - 1) * k).cuda()
    b_ih0 = ((torch.rand(GH, generator=gen) * 2 - 1) * k).cuda()
    xp = x @ w_ih0 + b_ih0
    if kind == "stack":
        op = getattr(ops, f"{cell}_stack")
        args = (xp, w_hh, b_hh, w_ih, b_ih)
        plain = ops.stack_ref
    else:
        op = getattr(ops, f"{cell}_scan")
        args = (xp, w_hh[0], b_hh[0])
        plain = getattr(ops, f"{cell}_scan_ref")
    lib = (torch.nn.LSTM if cell == "lstm" else torch.nn.GRU)(
        in_size, Hd, num_layers=L, batch_first=True).cuda()
    with torch.no_grad():
        for l in range(L):
            getattr(lib, f"weight_ih_l{l}").copy_((w_ih0 if l == 0 else w_ih[l - 1]).t())
            getattr(lib, f"bias_ih_l{l}").copy_(b_ih0 if l == 0 else b_ih[l - 1])
            getattr(lib, f"weight_hh_l{l}").copy_(w_hh[l].t())
            getattr(lib, f"bias_hh_l{l}").copy_(b_hh[l])
    n_w = (2 * L - 1) if kind == "stack" else 1  # H x GH matrices the kernel applies
    bound, by = _bound_ms(4 * (B * T_ * GH + B * T_ * Hd + n_w * (Hd + 1) * GH),
                          2 * B * T_ * n_w * Hd * GH)
    with torch.inference_mode():
        lib_diff = (lib(x)[0] - op(*args)).abs().max().item()
        device_ms = _graph_ms(torch, lambda: op(*args), 20)
        library_device_ms, via = _library_device_ms(torch, lambda: lib(x))
        return {
            "shape": [B, T_, Hd, L], "design": ops.design(T_, Hd, L, n_gates),
            "ms": _events_ms(torch, lambda: op(*args), 20),
            "device_ms": device_ms, "us_per_step": device_ms / (T_ * L) * 1e3,
            "plain_ms": _events_ms(torch, lambda: plain(*args), 3, warmup=1),
            "library_ms": _events_ms(torch, lambda: lib(x), 20),
            "library_device_ms": library_device_ms, "library_device_via": via,
            "library_max_abs_diff": lib_diff,
            "bound_ms": bound, "bound_by": by,
        }


def _kernel_timings(torch, gen, launches, errs, gpu):
    from vct_torch.ops import lstm as rnn_ops
    from vct_torch.ops.preprocess import normalize_frames, normalize_frames_ref
    from vct_torch.ops.selective_scan import _launch as _scan_launch
    from vct_torch.ops.selective_scan import decode_plan
    from vct_torch.ops.selective_scan import plan as scan_plan
    from vct_torch.ops.selective_scan import plan_code as scan_plan_code
    from vct_torch.ops.selective_scan import selective_scan, selective_scan_ref

    def k3(B, L, D, N):
        args = _scan_inputs(torch, gen, B, L, D, N)
        bound, by = _bound_ms(4 * (3 * B * L * D + 2 * B * L * N + D * N), 7 * B * L * D * N)
        device_ms = _graph_ms(torch, lambda: selective_scan(*args), 20)
        code = scan_plan_code(B, D, N)
        return {
            "shape": [B, L, D, N], "plan": scan_plan(B, D, N),
            "ms": _events_ms(torch, lambda: selective_scan(*args), 20),
            # the wrapper's part of ms: the same launch without its checks and count
            "launch_ms": _events_ms(torch, lambda: _scan_launch(*args, False, code), 20),
            "device_ms": device_ms, "us_per_step": device_ms / L * 1e3,
            "plain_ms": _events_ms(torch, lambda: selective_scan_ref(*args), 3),
            "bound_ms": bound, "bound_by": by,
            # one expf a state and step, on the SFUs' MUFU.EX2 (16 a clock per SM)
            "expf_bound_ms": B * L * D * N / SFU_EXP_PER_S * 1e3,
        }

    def k3_plans(B, L, D, N):
        """Device time of the kernel under each S, with the plan's blocks and
        chunks and with 64- and 256-thread blocks and 32-step chunks, against
        the plan's choice; each checked against the plain version first."""
        args = _scan_inputs(torch, gen, B, L, D, N)
        want = selective_scan_ref(*args)
        times = {}
        for S in (1, 2):
            for threads, chunk in ((0, 0), (64, 0), (256, 0), (0, 32)):
                code = scan_plan_code(B, D, N, S, threads, chunk)
                p = decode_plan(code, N)
                got = _scan_launch(*args, False, code)
                torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
                key = (f"S{S}_lanes{p['lanes_per_channel']}_T{p['block_threads']}"
                       f"_C{p['chunk_steps']}")
                times[key] = _graph_ms(torch, lambda: _scan_launch(*args, False, code), 20)
        return {"shape": [B, L, D, N], "plan": scan_plan(B, D, N), "device_ms": times}

    def k6(shape):
        x = torch.randint(0, 256, shape, dtype=torch.uint8, generator=gen).cuda()
        mean, std = torch.tensor(IMAGENET_MEAN).cuda(), torch.tensor(IMAGENET_STD).cuda()
        n = x.numel()
        # 1 byte read and 4 written per element, the (C,) mean and std read;
        # 4 operations per element: widen, scale, subtract, multiply.
        bound, by = _bound_ms(5 * n + 2 * 4 * 3, 4 * n)
        return {
            "shape": list(shape), "stats": "imagenet",
            "ms": _events_ms(torch, lambda: normalize_frames(x, mean, std), 20),
            "device_ms": _graph_ms(torch, lambda: normalize_frames(x, mean, std), 20),
            "plain_ms": _events_ms(torch, lambda: normalize_frames_ref(x, mean, std), 5),
            "bound_ms": bound, "bound_by": by,
        }

    t1, t3 = _k1_timing(torch, gen, 32, 2 * T), k3(32, T, 16, 32)
    t4, t6 = _k4_timing(torch, gen, 32, 2 * T), k6((32, T, H, W, 3))
    kernels = [
        {"name": "pair_scores", "route": "cuda", "source": "vct_torch/csrc/pair_scores.cu",
         "replaces": "vct/ops/pair_scores_pallas.py:119", "launches": launches["pair_scores"],
         "max_abs_err": errs["pair_scores"], "ms": t1["ms"], "plain_ms": t1["plain_ms"],
         "bound_ms": t1["bound_ms"], "bound_by": t1["bound_by"], "library_ms": None,
         "device_ms": t1["device_ms"], "shape": t1["shape"], "plan": t1["plan"],
         "launch_ms": t1["launch_ms"]},
        {"name": "selective_scan", "route": "cuda", "source": "vct_torch/csrc/selective_scan.cu",
         "replaces": "vct/ops/selective_scan_pallas.py:111",
         "launches": launches["selective_scan"], "max_abs_err": errs["selective_scan"],
         "ms": t3["ms"], "plain_ms": t3["plain_ms"], "bound_ms": t3["bound_ms"],
         "bound_by": t3["bound_by"], "library_ms": None,
         "device_ms": t3["device_ms"], "shape": t3["shape"], "plan": t3["plan"],
         "us_per_step": t3["us_per_step"], "expf_bound_ms": t3["expf_bound_ms"],
         "launch_ms": t3["launch_ms"]},
        {"name": "ssim_pair_scores", "route": "cuda", "source": "vct_torch/csrc/ssim.cu",
         "replaces": "vct/ops/ssim_pallas.py:156", "launches": launches["ssim_pair_scores"],
         "max_abs_err": errs["ssim_pair_scores"], "ms": t4["ms"], "plain_ms": t4["plain_ms"],
         "bound_ms": t4["bound_ms"], "bound_by": t4["bound_by"], "library_ms": None,
         "bound_counts": t4["bound_counts"], "device_ms": t4["device_ms"], "shape": t4["shape"],
         "plan": t4["plan"]},
        {"name": "normalize_frames", "route": "cuda", "source": "vct_torch/csrc/normalize.cu",
         "replaces": "vct/ops/preprocess_pallas.py:34", "launches": launches["normalize_frames"],
         "paths": "none: no serving path calls it, as in vct",
         "max_abs_err": errs["normalize_frames"], "ms": t6["ms"], "plain_ms": t6["plain_ms"],
         "bound_ms": t6["bound_ms"], "bound_by": t6["bound_by"], "library_ms": None,
         "device_ms": t6["device_ms"], "shape": t6["shape"]},
    ]
    for name in RNN_KERNELS:
        cell, kind = name.split("_")
        t = _rnn_timing(torch, gen, rnn_ops, cell, kind, 32, T_UCF50, 56, 4)
        kernels.append({
            "name": name, "route": "cuda", "source": "vct_torch/csrc/lstm.cu",
            "replaces": RNN_KERNELS[name], "launches": launches[name], "max_abs_err": errs[name],
            **{key: t[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                                       "device_ms", "us_per_step", "design", "library_device_ms",
                                       "library_device_via", "library_max_abs_diff", "shape")},
        })
    extra = {"extra_timings": {
        "pair_scores_B32_L120_flow": _k1_timing(torch, gen, 32, 2 * T, method="flow"),
        "pair_scores_B1_L120_sad": _k1_timing(torch, gen, 1, 2 * T),
        "pair_scores_B1_L240_sad": _k1_timing(torch, gen, 1, 4 * T),
        "pair_scores_B1_L120_320x240_sad": _k1_timing(torch, gen, 1, 2 * T, 240, 320),
        "pair_scores_plans": [_k1_plans(torch, gen, *shape) for shape in K1_SHAPES],
        "ssim_pair_scores_B1_L120": _k4_timing(torch, gen, 1, 2 * T),
        "ssim_pair_scores_B1_L240": _k4_timing(torch, gen, 1, 4 * T),
        "ssim_pair_scores_B1_L120_320x240": _k4_timing(torch, gen, 1, 2 * T, 240, 320),
        "ssim_pair_scores_plans": [_k4_plans(torch, gen, *shape) for shape in SSIM_PLAN_SHAPES],
        "selective_scan_B4_served": k3(4, T, 16, 32),
        "selective_scan_D2048_N16": k3(2, 256, 2048, 16),
        "selective_scan_N64": k3(32, T, 32, 64),
        "selective_scan_plans": [k3_plans(*dims) for dims in SCAN_PLAN_SHAPES],
        "lstm_stack_B4_served": _rnn_timing(torch, gen, rnn_ops, "lstm", "stack", 4, T_UCF50, 56, 4),
        "gru_stack_B4_served": _rnn_timing(torch, gen, rnn_ops, "gru", "stack", 4, T_UCF50, 56, 4),
        "lstm_stack_H64_L4": _rnn_timing(torch, gen, rnn_ops, "lstm", "stack", 32, T_UCF50, 64, 4),
        "gru_stack_H64_L4": _rnn_timing(torch, gen, rnn_ops, "gru", "stack", 32, T_UCF50, 64, 4),
        "lstm_stack_default_H32_T60_L3": _rnn_timing(torch, gen, rnn_ops, "lstm", "stack", 32, T,
                                                     32, 3),
        "lstm_stack_H65_L4": _rnn_timing(torch, gen, rnn_ops, "lstm", "stack", 32, T_UCF50, 65, 4),
        "lstm_stack_H256_L2": _rnn_timing(torch, gen, rnn_ops, "lstm", "stack", 2, 16, 256, 2,
                                          in_size=256),
        "lstm_stack_bwd_T130": _bwd_timing(torch, gen, "lstm_stack_bwd",
                                           (TRAIN_BATCH, BWD_LONG_T, 56, 4)),
        "selective_scan_bwd_videomamba": _bwd_timing(torch, gen, "selective_scan_bwd",
                                                     VIDEOMAMBA_SCAN),
    }, "gpu": gpu}
    print(json.dumps(extra))
    return kernels


def k1_timings(torch, root: Path) -> dict:
    """``_k1_timing`` at K1's five timed shapes (the bench step, SAD and flow,
    the two served buckets, one decoded 320x240 video) for the
    ``vct_torch`` package at ``root``: this checkout's, or an older one's."""
    sys.path.insert(0, str(root))
    gen = torch.Generator().manual_seed(0)
    return {"k1_timings": [_k1_timing(torch, gen, 32, 2 * T, method=m) for m in ("sad", "flow")]
            + [_k1_timing(torch, gen, *shape[:4]) for shape in K1_SHAPES[1:]],
            "root": str(root), "gpu": _gpu_line()}


def bwd_timings(torch, root: Path) -> dict:
    """The backward entry points at the training path's shapes, by events
    and from a CUDA graph, for the ``vct_torch`` package at ``root``: this
    checkout's or an older one's. K3's at the deployed step and at
    VideoMamba's shape, with the device launches a call (``torch.profiler``);
    K2/K5's at the bench stack (K5 its first layer), and the LSTM stack's at
    T = BWD_LONG_T (three staged chunks). Uses only the entry points and
    K2's forward ``_launch``."""
    sys.path.insert(0, str(root))
    from vct_torch.ops import lstm as ops
    from vct_torch.ops import selective_scan as k3

    gen = torch.Generator().manual_seed(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    rows = {}
    for label, dims in (("selective_scan_bwd", (TRAIN_BATCH, T, 16, 32)),
                        ("selective_scan_bwd_videomamba", VIDEOMAMBA_SCAN)):
        args = _scan_inputs(torch, gen, *dims)
        gy = torch.randn(dims[:3], generator=gen).cuda()
        fn = lambda: k3.selective_scan_bwd(*args, gy)  # noqa: E731
        rows[label] = {"shape": list(dims), "ms": _events_ms(torch, fn, 20),
                       "device_ms": _graph_ms(torch, fn, 20),
                       "kernel_launches": _kernels_a_call(torch, fn)}
    cases = [(n, T_UCF50) for n in BWD_KERNELS if n != "selective_scan_bwd"]
    for name, T_ in cases + [("lstm_stack_bwd", BWD_LONG_T)]:
        cell, kind, _ = name.split("_")
        n_gates = 4 if cell == "lstm" else 3
        xp, w_hh, b_hh, w_ih, b_ih = _rnn_inputs(torch, gen, n_gates, TRAIN_BATCH, T_, 56, 4)
        gy = torch.randn(TRAIN_BATCH, T_, 56, generator=gen).cuda()
        if kind == "stack":
            y, hs, _ = ops._launch(f"{cell}_stack", n_gates, xp, w_hh, b_hh, w_ih, b_ih, save=True)
            fn = lambda: getattr(ops, name)(xp, w_hh, b_hh, w_ih, b_ih, hs, y, gy)  # noqa: E731
        else:
            args = (xp, w_hh[0], b_hh[0])
            y, _, _ = ops._launch(f"{cell}_scan", n_gates, *args)
            fn = lambda: getattr(ops, name)(*args, y, gy)  # noqa: E731
        rows[name if T_ == T_UCF50 else f"{name}_T{T_}"] = {
            "ms": _events_ms(torch, fn, 20), "device_ms": _graph_ms(torch, fn, 20)}
    return {"bwd_timings": rows, "root": str(root), "gpu": _gpu_line()}


def main(argv: list[str]) -> int:
    """With no arguments, every phase; with ``--k1-timing [ROOT]`` or
    ``--bwd-timing [ROOT]``, only ``k1_timings`` or ``bwd_timings`` of the
    package at ROOT (default: this checkout)."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    here = Path(__file__).resolve().parent
    if argv[:1] in (["--k1-timing"], ["--bwd-timing"]):
        timings = k1_timings if argv[0] == "--k1-timing" else bwd_timings
        print(json.dumps(timings(torch, Path(argv[1]).resolve() if argv[1:] else here)))
        return 0
    sys.path.insert(0, str(here))
    from vct_torch.ops import _build

    gpu = _gpu_line()
    print(f"gpu: {gpu}", flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    t0 = time.perf_counter()
    _build.load_kernels()
    print(f"build: {time.perf_counter() - t0:.2f} s into {_build.build_dir()}", flush=True)
    log = (_build.build_dir() / "build.log").read_text()
    print("\n".join(_ptxas_lines(log)))
    spills = _bwd_spills(log)
    spilled = {k: v for k, v in spills.items() if v}
    print(f"K2/K5 backward: {len(spills)} register-design instances, spill bytes {spilled or 0}")
    if spilled:
        raise AssertionError(f"backward register instances spill: {spilled}")

    gen = torch.Generator().manual_seed(0)
    errs = {"pair_scores": _check_pair_scores(torch, gen),
            "ssim_pair_scores": _check_ssim(torch, gen),
            "normalize_frames": _check_normalize(torch, gen),
            "selective_scan": _check_selective_scan(torch, gen),
            **_check_rnn(torch, gen)}
    bwd_errs = _check_backward(torch, gen)

    from vct_torch.core.config import ModelConfig
    from vct_torch.models import build_model

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model = build_model(ModelConfig(**DEPLOYED, compute_dtype="bfloat16"), T, seed=0)
    # K1, K3: the SAD Mamba path's counts; K4: the SSIM Mamba path's.
    launches = _serve_deployed(torch, gpu, model, ("sad",) * 3, "deployed_mamba")
    ssim_launches = _serve_deployed(torch, gpu, model, ("ssim", "ssim_most_unique", "ssim"),
                                    "deployed_mamba_ssim")
    del model
    rnn_launches = _recurrent_path(torch, gpu)
    print(f"LSTM/GRU path launches over the four heads {rnn_launches}")
    launches.update({n: rnn_launches[n] for n in RNN_KERNELS})
    launches["ssim_pair_scores"] = ssim_launches["ssim_pair_scores"]
    launches["normalize_frames"] = sum(
        c["normalize_frames"] for c in (launches, ssim_launches, rnn_launches))
    train_launches = _train_path(torch, gen, gpu)
    print(f"training path launches over both configurations {train_launches}")
    _resume_and_weights(torch, gpu)
    kernels = _kernel_timings(torch, gen, launches, errs, gpu)
    kernels += _bwd_rows(torch, gen, train_launches, bwd_errs)
    print(json.dumps({"kernels": kernels, "gpu": gpu}))
    print(_gpu_line())  # name, power limit: exactly as nvidia-smi prints them
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
