"""What the benchmark makes from a seed: the weights and the videos.

Both are drawn on the run's device by a ``torch.Generator`` there, in a few
large calls, so set-up pays no host-side drawing. The same seed gives the
same tensors; the program and the reference receive the same ones.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["subseed", "make_weights", "clip_seconds", "backlog_lengths", "make_videos"]

_MASK = (1 << 63) - 1


def subseed(seed: int, purpose: int) -> int:
    """A seed of its own for each use of the run's seed (any whole number)."""
    return (int(seed) * 1_000_003 + purpose * 7_919) & _MASK


def make_weights(spec: list, seed: int, device) -> dict:
    """name -> float32 tensor (int64 for counters) on ``device``, drawn as
    ``spec`` says (see ``reference.model.param_spec``)."""
    gen = torch.Generator(device=device).manual_seed(subseed(seed, 1))
    normal = [n for n, s, d, _ in spec if d in ("fan", "small", "unit", "normal")]
    uniform = [n for n, s, d, _ in spec if d in ("var", "uniform")]
    sizes = {n: int(np.prod(s, dtype=np.int64)) for n, s, _, _ in spec}
    pools = {
        "n": torch.randn(sum(sizes[n] for n in normal), generator=gen, device=device),
        "u": torch.rand(sum(sizes[n] for n in uniform), generator=gen, device=device) * 2 - 1,
    }
    offsets = {"n": 0, "u": 0}
    out = {}
    for name, shape, draw, arg in spec:
        if draw == "zero_long":
            out[name] = torch.zeros(shape, dtype=torch.int64, device=device)
            continue
        pool = "u" if draw in ("var", "uniform") else "n"
        x = pools[pool][offsets[pool]:offsets[pool] + sizes[name]].view(shape)
        offsets[pool] += sizes[name]
        if draw == "fan":
            x = x * arg ** -0.5
        elif draw == "small":
            x = x * 0.1
        elif draw == "unit":
            x = 1.0 + 0.1 * x
        elif draw == "var":
            x = 1.0 + 0.25 * x
        elif draw == "uniform":
            x = x * arg
        out[name] = x.clone()
    return out


def clip_seconds(lengths: dict, count: int) -> np.ndarray:
    """``count`` clip lengths in seconds, ascending: the quantiles at
    (i + 1/2) / count of the maximum-entropy distribution on
    [``min_s``, ``max_s``] whose mean is ``mean_s`` (an exponential in the
    length, cut at both ends), so that every seed gets the same set."""
    lo, hi, mean = float(lengths["min_s"]), float(lengths["max_s"]), float(lengths["mean_s"])
    width = hi - lo

    def mean_of(theta: float) -> float:  # the cut exponential's mean, theta its scale
        return lo + theta - width / np.expm1(width / theta)

    a, b = 1e-3 * width, 1e3 * width  # the mean rises with theta from lo to (lo + hi) / 2
    for _ in range(200):
        mid = 0.5 * (a + b)
        a, b = (mid, b) if mean_of(mid) < mean else (a, mid)
    theta = 0.5 * (a + b)
    u = (np.arange(count) + 0.5) / count
    return lo - theta * np.log1p(-u * -np.expm1(-width / theta))


def backlog_lengths(lengths: dict, count: int) -> np.ndarray:
    """``count`` frame counts, ascending: ``clip_seconds`` at ``fps``, at
    least one frame each."""
    frames = np.rint(clip_seconds(lengths, count) * float(lengths["fps"])).astype(np.int64)
    return np.maximum(frames, 1)


def make_videos(seed: int, purpose: int, lengths, L: int, frame, content: dict,
                device) -> torch.Tensor:
    """uint8 videos (B, L, H, W, C) on ``device``: runs of ``content["run"]``
    frames, a new random scene each, a share ``content["noisy_share"]`` of
    the runs with fresh noise of +-``content["noise"]`` on every frame, the
    rest static (equal frames, so SAD scores tie); each video padded from
    its length to L with its last frame."""
    H, W, C = frame
    rng = np.random.default_rng(subseed(seed, purpose))
    lo, hi = content["run"]
    scene_of, noisy_of = np.zeros((len(lengths), L), np.int64), np.zeros((len(lengths), L), bool)
    scenes = 0
    for b, n in enumerate(lengths):
        f = 0
        while f < n:
            run = int(rng.integers(lo, hi + 1))
            scene_of[b, f:f + run] = scenes
            noisy_of[b, f:f + run] = rng.random() < content["noisy_share"]
            scenes += 1
            f += run
        scene_of[b, n:] = scene_of[b, n - 1]
    gen = torch.Generator(device=device).manual_seed(subseed(seed, purpose + 1))
    pool = torch.randint(0, 256, (scenes, H, W, C), generator=gen, device=device,
                         dtype=torch.uint8)
    k = int(content["noise"])
    # The padded tail repeats the last real frame, its noise included.
    src = np.minimum(np.arange(L)[None, :], np.asarray(lengths)[:, None] - 1)
    out = torch.empty((len(lengths), L, H, W, C), dtype=torch.uint8, device=device)
    step = max(1, (1 << 28) // (L * H * W * C))  # int16 drafts of at most 512 MiB
    for b0 in range(0, len(lengths), step):
        b1 = min(b0 + step, len(lengths))
        noise = torch.randint(-k, k + 1, (b1 - b0, L, H, W, C), generator=gen, device=device,
                              dtype=torch.int16)
        noise *= torch.as_tensor(noisy_of[b0:b1], device=device)[:, :, None, None, None]
        rows = torch.arange(b1 - b0, device=device)[:, None]
        noise = noise[rows, torch.as_tensor(src[b0:b1], device=device)]
        frames = pool[torch.as_tensor(scene_of[b0:b1], device=device)].to(torch.int16) + noise
        out[b0:b1] = frames.clamp_(0, 255)
    return out
