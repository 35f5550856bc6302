"""K1: per-transition SAD / flow-proxy scores of consecutive integer frames.

Port of ``vct/ops/pair_scores_pallas.py::pair_scores`` (the TPU kernels
``_clip_kernel`` / ``_blocked_kernel``). The CUDA kernel is
``vct_torch/csrc/pair_scores.cu``; its note says what bounds it on the H100
(bytes: one read of every frame) and how its two designs meet that. For few
clips (one served video), "bands": tiles of (clip, chunk of K transitions,
band of the frame's 16-byte words), the bands of a (clip, chunk) a
thread-block cluster that adds its sums through distributed shared memory.
For many clips (the bench batch), "chunks": a block a clip's chunk of eight
transitions and whole frames. ``plan`` chooses the design and its tiles
from the shape.

``pair_scores`` calls the registered operator ``vct_torch::pair_scores``,
whose CPU implementation is the plain PyTorch version ``pair_scores_ref``
and whose CUDA implementation is the kernel; an exported program calls the
same operator. Both sum exactly in 64-bit integers and convert to f32 once,
so SAD and flow are both bit-equal to the plain version (``vct``
accumulates flow in f32; the port agrees with it within rtol 1e-5).
"""

from __future__ import annotations

import functools

import torch

from vct_torch.ops import _build

__all__ = ["pair_scores", "pair_scores_ref", "plan"]

_METHODS = ("sad", "flow")
SMS = 132  # streaming multiprocessors of an H100 SXM
MAX_CHUNK_PAIRS = 1024  # K: the kernel keeps a chunk's K sums in shared memory
MAX_CLUSTER = 8  # blocks a (clip, chunk): the portable cluster size
MAX_THREADS = 256
GROUP = 8  # frames a thread loads at once (the kernel's kGroup)
WORDS_PER_THREAD = (1, 2)  # the kernel's instances: 16-byte words of a band a thread
MAX_BLOCKS = 2**31 - 1  # the grid's x dimension
# The "chunks" design: a block takes CHUNK transitions of one clip and whole
# frames, CHUNK_THREADS threads; its grid's y dimension is the clip.
CHUNK = 8
CHUNK_THREADS = 256
MAX_CHUNK_CLIPS = 65535
# The plan's cost model, fitted to K1's device times on an H100 80GB HBM3
# (chip_smoke.py's pair_scores_plans and both designs at B = 2..32): a
# launch takes the largest of its frames' bytes over the rate the kernel
# reads at (a chunk's boundary frame, read twice, comes from L2), the
# busiest SM's bytes over the rate one SM reads at, and its rounds of
# loads, ROUND_S each (a thread's loads of one group of GROUP frames, or of
# one word in the chunks design, wait on the round before), for each wave
# of SMS blocks, or of CLUSTER_SLOTS blocks in clusters (the card's GPCs
# place 15 clusters of 8 at one block an SM: 16, 128 blocks, timed slower
# than 15); plus the design's fixed cost (the bands design's cluster launch
# and synchronisations cost more).
CLUSTER_SLOTS = 120
READ_BYTES_PER_S = 3.2e12
SM_BYTES_PER_S = 50e9
ROUND_S = 0.5e-6
FIXED_S = {"bands": 2.9e-6, "chunks": 2.0e-6}


@functools.lru_cache(maxsize=None)
def plan(B: int, L: int, H: int, W: int, C: int, chunk_pairs: int = 0, bands: int = 0,
         design: str = "") -> dict:
    """How a CUDA launch cuts (B, L, H, W, C) uint8 clips.

    Two designs. "chunks": a block takes CHUNK transitions of one clip and
    whole frames (``chunk_pairs`` = CHUNK, one band), CHUNK_THREADS threads
    walking their words one at a time. "bands": K = ``chunk_pairs``
    transitions a chunk, the frame's 16-byte words in ``bands`` bands of
    ``band_words`` (none empty; a band starts on a 16-byte boundary),
    ``cluster`` blocks a (clip, chunk) (block ``rank`` takes bands rank,
    rank + cluster, ...), ``threads`` threads a block, each holding
    ``words_per_thread`` words of a band.

    ``design``, ``chunk_pairs`` and ``bands`` at "" and 0 are chosen: the
    option of least modelled time (READ_BYTES_PER_S, SM_BYTES_PER_S,
    ROUND_S, FIXED_S, CLUSTER_SLOTS), then the fewer bytes on the busiest
    SM, then the fewer blocks; a forced K or band count keeps the bands
    design. A
    pure function of the shape; the kernel takes any plan this returns.
    """
    pairs, frame_bytes = L - 1, H * W * C
    if B < 1 or pairs < 1 or frame_bytes < 1 or design not in ("", "chunks", "bands"):
        raise ValueError(f"pair_scores: no plan for B={B}, L={L}, H={H}, W={W}, C={C}, "
                         f"design={design!r}")
    words = -(-frame_bytes // 16)
    read_s = B * L * frame_bytes / READ_BYTES_PER_S

    def cost(p, rounds, block_bytes):
        waves = -(-p["blocks"] // (CLUSTER_SLOTS if p["cluster"] > 1 else SMS))
        busiest = waves * block_bytes
        return (max(read_s, busiest / SM_BYTES_PER_S, waves * rounds * ROUND_S)
                + FIXED_S[p["design"]], busiest, p["blocks"])

    chunks = None
    if (design == "chunks" or (not design and not chunk_pairs and not bands)) and B <= MAX_CHUNK_CLIPS:
        chunks = {"design": "chunks", "chunk_pairs": CHUNK, "chunks": -(-pairs // CHUNK),
                  "bands": 1, "band_words": words, "cluster": 1, "threads": CHUNK_THREADS,
                  "words_per_thread": 0, "blocks": B * -(-pairs // CHUNK), "smem_bytes": 0}
    if design == "chunks":
        if chunks is None or chunk_pairs not in (0, CHUNK) or bands not in (0, 1):
            raise ValueError(f"pair_scores: the chunks design takes K={CHUNK}, one band and at "
                             f"most {MAX_CHUNK_CLIPS} clips")
        return chunks

    k_max = min(MAX_CHUNK_PAIRS, pairs)
    most = WORDS_PER_THREAD[-1] * MAX_THREADS  # words a band may have
    if (not 0 <= chunk_pairs <= k_max or not 0 <= bands <= words
            or (bands and -(-words // bands) > most)):
        raise ValueError(f"pair_scores: no plan with K={chunk_pairs}, bands={bands} "
                         f"for L={L}, H={H}, W={W}, C={C}")

    def bands_plan(K, nb):
        band_words = -(-words // nb)
        nb = -(-words // band_words)  # no empty band
        cluster = min(nb, MAX_CLUSTER)
        per = next(w for w in WORDS_PER_THREAD if band_words <= w * MAX_THREADS)
        threads = -(-band_words // (32 * per)) * 32
        chunks = -(-pairs // K)
        return {"design": "bands", "chunk_pairs": K, "chunks": chunks, "bands": nb,
                "band_words": band_words, "cluster": cluster, "threads": threads,
                "words_per_thread": per, "blocks": B * chunks * cluster,
                "smem_bytes": (1 + threads // 32) * K * 8}

    # Bands of at most two words a thread, a cluster's worth at least, in
    # whole clusters above one; K: the least K of each chunk count (a larger
    # K of the same count reads the same bytes in the same blocks).
    least = -(-words // most)
    if least > MAX_CLUSTER:
        least = -(-least // MAX_CLUSTER) * MAX_CLUSTER
    nbs = ([bands] if bands
           else sorted({min(words, max(least, n)) for n in range(1, MAX_CLUSTER + 1)}))
    ks = [chunk_pairs] if chunk_pairs else sorted({-(-pairs // c) for c in range(1, pairs + 1)
                                                   if -(-pairs // c) <= k_max})
    options = []
    for K in ks:
        for nb in nbs:
            p = bands_plan(K, nb)
            per_block = -(-p["bands"] // p["cluster"])  # bands a block takes
            options.append((cost(p, per_block * -(-K // GROUP),
                                 per_block * (K + 1) * p["band_words"] * 16), len(options), p))
    if chunks is not None:
        options.append((cost(chunks, -(-words // CHUNK_THREADS), (CHUNK + 1) * frame_bytes),
                        -1, chunks))
    return min(options, key=lambda o: o[:2])[2]


def _validate(clips: torch.Tensor, method: str) -> None:
    if method not in _METHODS:
        raise KeyError(f"pair_scores supports sad|flow, got {method!r}")
    if clips.dtype.is_floating_point or clips.dtype.is_complex or clips.dtype == torch.bool:
        raise TypeError(
            f"pair_scores wants integer frames (got {clips.dtype}); the float "
            "path is vct_torch.data.samplers.device_frame_scores"
        )
    if clips.dim() != 5:
        raise ValueError(f"pair_scores wants (B, L, H, W, C) clips, got {tuple(clips.shape)}")


def pair_scores_ref(clips: torch.Tensor, method: str = "sad") -> torch.Tensor:
    """Plain PyTorch version: (B, L, H, W, C) integer -> (B, L-1) f32."""
    _validate(clips, method)
    B, L = clips.shape[:2]
    if L < 2:
        return torch.zeros((B, 0), dtype=torch.float32, device=clips.device)
    wide = torch.int64 if method == "flow" else torch.int32
    x = clips.reshape(B, L, -1).to(wide)
    d = x[:, 1:] - x[:, :-1]
    per = d * d if method == "flow" else d.abs()
    return per.sum(dim=-1, dtype=torch.int64).to(torch.float32)


def pair_scores(clips: torch.Tensor, method: str = "sad") -> torch.Tensor:
    """Per-transition change score of every consecutive frame pair, batched.

    clips: (B, L, H, W, C) integer frames. Returns (B, L-1) f32. On CUDA
    the clips must be uint8 and contiguous; the kernel runs or this raises.
    """
    _validate(clips, method)
    if clips.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"pair_scores: no kernel for device {clips.device}")
    return torch.ops.vct_torch.pair_scores(clips, method)


@torch.library.custom_op("vct_torch::pair_scores", mutates_args=(), device_types="cpu")
def _op(clips: torch.Tensor, method: str) -> torch.Tensor:
    """The operator's CPU implementation: the plain version, uncounted."""
    return pair_scores_ref(clips, method)


@_op.register_kernel("cuda")
def _op_cuda(clips: torch.Tensor, method: str) -> torch.Tensor:
    """The operator's CUDA implementation: the checked, counted launch."""
    _validate(clips, method)
    if clips.dtype != torch.uint8:
        raise TypeError(f"the pair_scores kernel takes uint8 frames, got {clips.dtype}")
    if not clips.is_contiguous():
        raise ValueError("the pair_scores kernel takes contiguous clips")
    B, L, H, W, C = clips.shape
    if B == 0 or L < 2 or H * W * C == 0:
        return torch.zeros((B, max(L - 1, 0)), dtype=torch.float32, device=clips.device)
    p = plan(B, L, H, W, C)
    if p["blocks"] > MAX_BLOCKS:
        raise ValueError(f"the pair_scores kernel takes at most {MAX_BLOCKS} blocks; "
                         f"{B} clips need {p['blocks']}")
    out = _launch(clips, p, method == "flow")
    pair_scores.launches += 1
    return out


@_op.register_fake
def _op_fake(clips: torch.Tensor, method: str) -> torch.Tensor:
    return clips.new_empty((clips.shape[0], torch.sym_max(clips.shape[1] - 1, 0)),
                           dtype=torch.float32)


def _launch(clips: torch.Tensor, p: dict, square: bool) -> torch.Tensor:
    """The kernel under plan ``p`` on contiguous uint8 CUDA clips, no
    checks, no count."""
    B, L, H, W, C = clips.shape
    device = clips.device
    out = torch.empty((B, L - 1), dtype=torch.float32, device=device)
    lib = _build.load_kernels()
    args = (clips.data_ptr(), out.data_ptr(), B, L, H * W * C, int(square),
            int(p["design"] == "chunks"), p["chunk_pairs"], p["bands"], p["cluster"], p["threads"],
            p["words_per_thread"])
    if device.index == torch.cuda.current_device():
        err = lib.vct_pair_scores(*args, torch._C._cuda_getCurrentRawStream(device.index))
    else:
        with torch.cuda.device(device):
            err = lib.vct_pair_scores(*args, torch._C._cuda_getCurrentRawStream(device.index))
    _build.check(lib, err, "pair_scores kernel launch")
    return out


pair_scores.launches = 0
