"""Traffic kind ``serve_backlog``: one client drains a backlog of videos, a
batch at a time (a closed loop), through the worker's path.

The backlog: ``batch`` x ``distinct_batches`` decoded uint8 videos whose
frame counts are the same set for every seed (``core/data.py::
backlog_lengths``, from the published clip-length statistic in
``lengths``), grouped by length into batches of ``batch``. Each batch is
padded with its videos' last frames to the bucket of its longest video, by
the port's rule for decoded videos (``vct_torch/serve/deployment.py::
sample_decoded_clips``: T where no video is longer, else T x 2^k, at least
2T), and kept in pinned host memory; the seed orders the batches and the
videos in them and draws their content. A batch: the copy to the card,
selection to T frames there (``device_sample_clips``), ``classify_videos``,
the probabilities back on the host. The window runs whole cycles of the
backlog. Once it has closed, every answer of it is compared with the
reference's (``judge``).

The configuration's float32 is run as stated: TF32 off for the program and
the reference alike (``reference/precision.py``).

End-to-end: ``serve_clips_per_s`` (videos classified over the window's
time) and ``serve_p95_ms`` (the 95th percentile of a batch's time, from its
copy's start to its probabilities on the host).
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from bench_port.core import data
from bench_port.core.trace import ModuleRanges, Stretch, View, launch_counts, span
from bench_port.reference import model as ref
from bench_port.reference.precision import check_stated, tf32

__all__ = ["bucket", "Batch", "backlog", "run", "program_model", "serve", "reference_logp",
           "answer_gaps", "judge", "readings"]


def bucket(longest: int, T: int) -> int:
    """The frames a batch is padded to: T where no video is longer than T
    (the port pads such a video to T without selection), else the port's
    ``_length_bucket``, T x 2^k from 2T up."""
    if longest <= T:
        return T
    size = 2 * T
    while size < longest:
        size *= 2
    return size


@dataclass
class Batch:
    raw: torch.Tensor  # (B, L, H, W, C) uint8, pinned on a card's host
    lens: torch.Tensor  # (B,) int64, pinned likewise
    lengths: np.ndarray  # (B,) the same, on the host

    @property
    def L(self) -> int:
        return int(self.raw.shape[1])


def backlog(r, cfg: dict, tr: dict) -> list:
    """The cell's distinct batches, in the seed's order."""
    T, frame, B, n = cfg["sequence_length"], tuple(cfg["frame"]), tr["batch"], \
        tr["distinct_batches"]
    pin = r.device.type == "cuda"
    lengths = data.backlog_lengths(tr["lengths"], n * B)  # ascending: grouped by length
    rng = np.random.default_rng(data.subseed(r.seed, 10))
    out = []
    for j, i in enumerate(rng.permutation(n)):
        lens = rng.permutation(lengths[i * B:(i + 1) * B])
        videos = data.make_videos(r.seed, 1000 + 10 * j, lens, bucket(int(lens.max()), T),
                                  frame, tr["content"], r.device)
        raw = torch.empty(videos.shape, dtype=torch.uint8, pin_memory=pin)
        raw.copy_(videos)
        del videos
        lens_t = torch.as_tensor(lens, dtype=torch.int64)
        out.append(Batch(raw, lens_t.pin_memory() if pin else lens_t, lens))
    return out


def program_model(cfg: dict, weights: dict, device):
    """The program's model of ``cfg`` with the benchmark's weights, served
    as the program builds it (channels-last, eval mode)."""
    from vct_torch.core.config import ModelConfig
    from vct_torch.models import MODEL_FAMILIES

    mcfg = ModelConfig(**cfg["model"])
    with torch.device("meta"):
        model = MODEL_FAMILIES.get(mcfg.model_family)(mcfg, cfg["sequence_length"])
    model.to_empty(device=device)
    model.load_state_dict(weights, strict=True)
    return model.to(memory_format=torch.channels_last).eval()


def reference_logp(cfg: dict, seed: int, batches: list, device, kind: str = "float32",
                   head_kind: str | None = None):
    """The reference's log-probabilities (B, classes) of every batch, float64
    on the host, its backbone in ``kind`` and its head in ``head_kind``
    (``kind`` where None); and, at the stated precision only, the probe's
    scale: the median over the videos of the widest move of their
    log-probabilities when the features move by a TF32 unit
    (``reference.model.probe_features``)."""
    T = cfg["sequence_length"]
    stated = kind == "float32" and head_kind in (None, "float32")
    w = data.make_weights(ref.param_spec(cfg), seed, device)
    gen = torch.Generator(device=device).manual_seed(data.subseed(seed, 4))
    out, moves = [], []
    with torch.no_grad(), tf32(False):
        for b in batches:
            raw = b.raw.to(device)
            frames = ref.frames_f32(raw, ref.sad_indices(raw, b.lengths, T))
            n = frames.shape[0]
            feats = ref.backbone(w, frames.reshape((n * T,) + tuple(frames.shape[2:])), cfg,
                                 kind).reshape(n, T, -1)
            logp = torch.log_softmax(ref.head(w, feats, cfg, head_kind or kind), dim=-1)
            out.append(logp.double().cpu().numpy())
            if stated:
                moved = torch.log_softmax(ref.head(w, ref.probe_features(feats, gen), cfg), -1)
                moves.append((moved - logp).abs().amax(dim=-1).double().cpu().numpy())
    return out, (float(np.median(np.concatenate(moves))) if moves else None)


def answer_gaps(probs, want_logp: np.ndarray) -> np.ndarray:
    """Each video's widest gap between the log-probabilities of an answer
    and the reference's; inf for an answer of the wrong shape or not finite."""
    probs = np.asarray(probs, np.float64)
    if probs.shape != want_logp.shape or not np.isfinite(probs).all():
        return np.full(want_logp.shape[0], np.inf)
    return np.abs(np.log(np.maximum(probs, 1e-300)) - want_logp).max(axis=1)


def judge(gaps: np.ndarray, scale: float, limits: dict) -> tuple:
    """(checks, failed videos, notes) of the answers' gaps: ``logp_rel``,
    the widest gap in units of the probe's scale, and ``bad_answers``, the
    videos whose answer had the wrong shape or was not finite."""
    if not scale > 0:
        raise ValueError("the reference's answers do not move with its features: no scale "
                         "to judge the answers by")
    finite = gaps[np.isfinite(gaps)]
    widest = float(finite.max()) if finite.size else 0.0
    bad = int(np.sum(~np.isfinite(gaps)))
    checks = {"logp_rel": (widest / scale, limits["logp_rel"]), "bad_answers": (bad, 0)}
    failed = int(np.sum(~(gaps <= limits["logp_rel"] * scale)))
    return checks, failed, {"logp_gap": widest, "probe_scale": scale}


def serve(model, b: Batch, cfg: dict, tr: dict, device, trace: bool = False) -> np.ndarray:
    """One batch through the worker's path: the copy to the card, selection,
    the classifier, probabilities on the host."""
    from vct_torch.data.preprocess import device_sample_clips
    from vct_torch.serve.deployment import classify_videos

    with span("bp.copy", trace):
        raw = b.raw.to(device, non_blocking=True)
        lens = b.lens.to(device, non_blocking=True)
    with span("bp.select", trace):
        clips = device_sample_clips(raw, cfg["sequence_length"], method=tr["sampling"],
                                    lengths=lens)
    with span("bp.classify", trace):
        return classify_videos(model, clips, batch_size=tr["batch"], device=device)


def run(r) -> dict:
    check_stated(r.cell.config)
    with tf32(False):
        return _run(r)


def _run(r) -> dict:
    cfg, tr, dev = r.cell.config, r.cell.traffic, r.device
    B = tr["batch"]
    r.phase("imports")
    model = program_model(cfg, data.make_weights(ref.param_spec(cfg), r.seed, dev), dev)
    r.phase("model")
    batches = backlog(r, cfg, tr)
    n = len(batches)
    r.phase("backlog")
    ranges = ModuleRanges(model, cfg["ranges"]) if r.trace else None
    for _ in range(tr["warmup_cycles"]):
        for b in batches:
            serve(model, b, cfg, tr, dev)
    r.sync()
    r.phase("warmup")

    latencies, answers = [], []

    def one(i: int, traced: bool = False) -> None:
        t0 = time.perf_counter()
        probs = serve(model, batches[i], cfg, tr, dev, traced)
        latencies.append(time.perf_counter() - t0)
        answers.append((i, probs))

    t_window = time.perf_counter()
    setup_s = t_window - r.t_start
    stretch, first_traced = None, 0
    while True:  # whole cycles of the backlog
        if time.perf_counter() - t_window >= r.seconds and (not r.trace or stretch is not None):
            break
        if r.trace and stretch is None and len(latencies) >= tr["trace_from_cycle"] * n:
            before, first_traced = launch_counts(), len(latencies)
            with Stretch(dev) as stretch:
                for _ in range(tr["trace_cycles"]):
                    for i in range(n):
                        one(i, True)
            r.note({"launches_in_stretch": {k: v - before.get(k, 0)
                                            for k, v in launch_counts().items()
                                            if v - before.get(k, 0)}})
        else:
            for i in range(n):
                one(i)
    window_s = time.perf_counter() - t_window
    peak = r.memory_peak()
    if ranges is not None:
        ranges.remove()
    del model
    r.free()

    want, scale = reference_logp(cfg, r.seed, batches, dev)
    gaps = np.concatenate([answer_gaps(p, want[i]) for i, p in answers])
    checks, failed, notes = judge(gaps, scale, r.cell.limits)
    r.note({"compared": notes})
    view = None
    if stretch is not None:
        traced = range(first_traced, first_traced + tr["trace_cycles"] * n)
        shapes = [{"batch": B, "L": batches[answers[k][0]].L} for k in traced]
        untraced_s = sum(latencies) - sum(latencies[k] for k in traced)
        view = View(stretch.trace, shapes, cfg, tr,
                    untraced_clips=B * (len(latencies) - len(shapes)), untraced_s=untraced_s)
    return {
        "e2e": {"setup_s": setup_s,
                "serve_clips_per_s": B * len(latencies) / window_s,
                "serve_p95_ms": float(np.percentile(latencies, 95)) * 1e3},
        "attempted": int(gaps.size),
        "failed": failed,
        "checks": checks,
        "memory_peak_bytes": peak,
        "view": view,
    }


# --- readings: what the cell's limits are set from (tools/readings.py) -------

# The program's runs: name -> (TF32 for matrix products, TF32 for cuDNN).
PROGRAM_RUNS = {
    "sound": (False, False),  # as the configuration states: the lower readings
    "control": (True, True),  # the program's own TF32 path: the control
    "tf32_head": (True, False),  # TF32 in the products (the head's) alone
    "tf32_backbone": (False, True),  # TF32 in the convolutions alone
}
# The reference put in the program's place: name -> (backbone kind, head kind).
REFERENCE_RUNS = {
    "ref_tf32": ("tf32", "tf32"),  # the reference at TF32 (operands rounded)
    "ref_bf16_head": ("float32", "bfloat16"),  # the head alone in bfloat16
}


def readings(cell, r, what) -> dict:
    """For one seed (``r.seed``), the number the cell compares
    (``logp_rel``) from every run of ``what`` (names of ``PROGRAM_RUNS`` and
    ``REFERENCE_RUNS``) on every batch of the backlog once, against the
    reference at the stated precision."""
    cfg, tr = cell.config, cell.traffic
    check_stated(cfg)
    batches = backlog(r, cfg, tr)
    got = {}
    wanted = [name for name in what if name in PROGRAM_RUNS]
    if wanted:
        model = program_model(cfg, data.make_weights(ref.param_spec(cfg), r.seed, r.device),
                              r.device)
        for name in wanted:
            with tf32(*PROGRAM_RUNS[name]):
                got[name] = [serve(model, b, cfg, tr, r.device) for b in batches]
        del model
        if r.device.type == "cuda":
            torch.cuda.empty_cache()
    want, scale = reference_logp(cfg, r.seed, batches, r.device)
    out = {"probe_scale": scale}
    for name in what:
        if name in REFERENCE_RUNS:
            logp, _ = reference_logp(cfg, r.seed, batches, r.device, *REFERENCE_RUNS[name])
            got[name] = [np.exp(x) for x in logp]
        elif name not in PROGRAM_RUNS:
            raise KeyError(f"no reading {name!r}")
    for name, answers in got.items():
        widest = float(max(answer_gaps(p, w).max() for p, w in zip(answers, want)))
        out[name] = {"logp_gap": widest, "logp_rel": widest / scale}
    return out
