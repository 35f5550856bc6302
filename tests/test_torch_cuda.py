"""vct_torch's CUDA kernels against their plain versions, on the card.

Every case is marked ``cuda`` and skips without an NVIDIA GPU. The file
imports no JAX, so it runs on a machine that has only PyTorch; there, skip
the root conftest (it exists for JAX's CPU re-exec):

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda -q

Tolerances: SAD and flow exact (both sides sum exactly in integers and
round once; the K1 cases after a NaN fill of shared memory); SSIM
atol 2e-6 (vct's own tolerance) and, for the cases after a NaN fill of
shared memory, bit-equal (the kernel repeats the plain version's f32
operations unfused, up to exact scalings by two, and sums in f64); the frame
normalize exact; the selective scan and the LSTM/GRU recurrences
atol = rtol = 1e-5 (f32, summation order and fused multiply-adds; each
LSTM/GRU shape also asserts which kernel design it takes, and the scan's
cases run after NaN was left in shared memory); logits atol = rtol = 1e-4
with TF32 off; the zoo's models built on the card against the CPU, logits
atol = rtol = 1e-3 (f32, TF32 off: whole backbones whose convolutions sum
in other orders, as chip_smoke.py holds the card against the CPU); the
backward kernels within BWD_RTOL of each gradient's largest magnitude, the
LSTM/GRU register design's cases (``_check_rnn_backward``) with the kernel
and the f32 plain version each held against the plain version in float64,
dw_hh there elementwise within the larger of that and f32's rounding bound
for its sum of B·T products.
Every input is drawn from a seeded generator (``_gen``).
"""

import math

import numpy as np
import pytest
import torch

from vct_torch.core.config import ModelConfig
from vct_torch.data import preprocess
from vct_torch.models import build_model
from vct_torch.ops import _build
from vct_torch.ops import lstm as rnn_ops
from vct_torch.ops import pair_scores as k1_ops
from vct_torch.ops.pair_scores import pair_scores, pair_scores_ref
from vct_torch.ops.preprocess import normalize_frames, normalize_frames_ref
from vct_torch.ops import selective_scan as scan_ops
from vct_torch.ops.selective_scan import selective_scan, selective_scan_ref
from vct_torch.ops import ssim as ssim_ops
from vct_torch.ops.ssim import ssim_pair_scores, ssim_pair_scores_ref
from vct_torch.serve.deployment import classify_videos, sample_decoded_clips

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _clips(shape, seed=0):
    return np.random.RandomState(seed).randint(0, 256, size=shape, dtype=np.uint8)


def _gen(device, seed=0):
    """A seeded generator on ``device``. Nothing seeds the global CUDA
    generator, so a draw from it would depend on the tests run before."""
    return torch.Generator(device=device).manual_seed(seed)


@pytest.mark.parametrize("method", ["sad", "flow"])
@pytest.mark.parametrize("shape", [(4, 19, 80, 80, 3), (2, 21, 16, 48, 1), (3, 13, 7, 5, 1)])
def test_pair_scores_kernel_matches_plain(cuda_device, shape, method):
    x = torch.from_numpy(_clips(shape)).to(cuda_device)
    before = pair_scores.launches
    got = pair_scores(x, method)
    want = pair_scores_ref(x, method)
    torch.cuda.synchronize()
    assert pair_scores.launches == before + 1
    assert torch.equal(got, want)


def _check_k1_after_nan_fill(x, p=None):
    """The K1 kernel, launched just after NaN was left in every SM's shared
    memory, bit-equal to the plain version for SAD and flow: under the
    plan's choice through ``pair_scores`` (one counted launch each), or
    under the forced plan p."""
    for method in ("sad", "flow"):
        before = pair_scores.launches
        _build.fill_shared_memory(float("nan"))
        if p is None:
            got = pair_scores(x, method)
            assert pair_scores.launches == before + 1
        else:
            got = k1_ops._launch(x, p, method == "flow")
        want = pair_scores_ref(x, method)
        torch.cuda.synchronize()
        assert torch.equal(got, want), method


@pytest.mark.parametrize("shape", [(1, 120, 80, 80, 3), (1, 240, 80, 80, 3), (32, 120, 80, 80, 3),
                                   (1, 120, 240, 320, 3)],
                         ids=["served120", "served240", "bench", "decoded320x240"])
def test_pair_scores_kernel_at_the_served_and_bench_plans(cuda_device, shape):
    """One video takes clusters of bands, about a block an SM; the bench
    batch the chunks design."""
    assert k1_ops.plan(*shape)["design"] == ("chunks" if shape[0] == 32 else "bands")
    _check_k1_after_nan_fill(torch.from_numpy(_clips(shape)).to(cuda_device))


@pytest.mark.parametrize("shape", [(1, 11, 18, 48, 3), (2, 24, 19, 40, 3), (3, 2, 80, 80, 3)],
                         ids=["vector", "bytes", "L2"])
def test_pair_scores_kernel_under_the_chunks_design(cuda_device, shape):
    _check_k1_after_nan_fill(torch.from_numpy(_clips(shape)).to(cuda_device),
                             k1_ops.plan(*shape, design="chunks"))


@pytest.mark.parametrize("nb", [1, 5, 17])
@pytest.mark.parametrize("K", [1, 3, 7])
@pytest.mark.parametrize("shape", [(1, 11, 18, 48, 3), (2, 24, 19, 40, 3)],
                         ids=["vector", "bytes"])
def test_pair_scores_kernel_under_forced_plans(cuda_device, shape, K, nb):
    """Chunks of K of 10 or 23 transitions and bands of 162 words (2592
    bytes a frame, the vector path) or 2280 bytes (the byte path), so the
    last chunk and band are short."""
    p = k1_ops.plan(*shape, K, nb)
    words = -(-math.prod(shape[2:]) // 16)
    assert (p["chunk_pairs"], p["bands"]) == (K, -(-words // -(-words // nb)))  # none empty
    _check_k1_after_nan_fill(torch.from_numpy(_clips(shape)).to(cuda_device), p)


@pytest.mark.parametrize("shape,nb", [((1, 120, 80, 80, 3), 20), ((1, 5, 1080, 1920, 3), 0),
                                      ((2, 30, 80, 80, 3), 1200)],
                         ids=["served_20_bands", "decoded1080p", "a_word_a_band"])
def test_pair_scores_kernel_with_more_bands_than_a_cluster(cuda_device, shape, nb):
    """Blocks take bands rank, rank + 8, ... in turn, their pieces streaming
    through one ring."""
    p = k1_ops.plan(*shape, 0, nb)
    assert p["bands"] > p["cluster"] == k1_ops.MAX_CLUSTER
    _check_k1_after_nan_fill(torch.from_numpy(_clips(shape)).to(cuda_device),
                             p if nb else None)


@pytest.mark.parametrize("shape", [(3, 13, 7, 5, 1), (1, 9, 5, 7, 3), (2, 9, 4, 4, 1),
                                   (4, 2, 80, 80, 3)],
                         ids=["odd_bytes", "105_bytes", "one_word", "L2"])
def test_pair_scores_kernel_byte_path_and_small_frames(cuda_device, shape):
    _check_k1_after_nan_fill(torch.from_numpy(_clips(shape)).to(cuda_device))


def test_pair_scores_kernel_unaligned_clips_take_the_byte_path(cuda_device):
    flat = torch.from_numpy(_clips((1 + 2 * 10 * 8 * 16 * 3,))).to(cuda_device)
    _check_k1_after_nan_fill(flat[1:].view(2, 10, 8, 16, 3))


@pytest.mark.parametrize("B", [3, 16], ids=["bands", "chunks"])
def test_pair_scores_kernel_scores_all_equal_frames_zero(cuda_device, B):
    x = torch.from_numpy(np.repeat(_clips((B, 1, 80, 80, 3)), 40, axis=1)).to(cuda_device)
    assert k1_ops.plan(*x.shape)["design"] == ("bands" if B == 3 else "chunks")
    for method in ("sad", "flow"):
        _build.fill_shared_memory(float("nan"))
        assert torch.equal(pair_scores(x, method), torch.zeros((B, 39), device=cuda_device))


def test_pair_scores_kernel_graph_replays_give_the_same_scores(cuda_device):
    """No scratch, no counter: a CUDA graph of a served bucket replayed three
    times gives the same, right scores."""
    x = torch.from_numpy(_clips((1, 120, 80, 80, 3))).to(cuda_device)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        pair_scores(x), pair_scores(x, "flow")
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        ys = pair_scores(x), pair_scores(x, "flow")
    replays = []
    for _ in range(3):
        _build.fill_shared_memory(float("nan"))
        graph.replay()
        replays.append([y.clone() for y in ys])
    torch.cuda.synchronize()
    wants = pair_scores_ref(x), pair_scores_ref(x, "flow")
    assert all(torch.equal(r, w) for rs in replays for r, w in zip(rs, wants))


def test_pair_scores_kernel_on_two_streams_at_once(cuda_device):
    """Each launch's cluster sums its tile in its own shared memory, so
    launches on two streams at once do not mix their sums."""
    xs = [torch.from_numpy(_clips((1, L, 80, 80, 3), seed=L)).to(cuda_device) for L in (120, 240)]
    methods = ("sad", "flow")
    wants = [[pair_scores_ref(x, m) for m in methods] for x in xs]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    outs = [[], []]
    for _ in range(20):
        for i, (s, x) in enumerate(zip(streams, xs)):
            with torch.cuda.stream(s):
                outs[i].append([pair_scores(x, m) for m in methods])
    torch.cuda.synchronize()
    assert all(torch.equal(y, w) for ys, ws in zip(outs, wants) for pair in ys
               for y, w in zip(pair, ws))


@pytest.mark.parametrize("shape", [(4, 19, 80, 80, 3), (1, 9, 11, 44, 3), (2, 21, 16, 48, 1),
                                   (3, 4, 3, 3, 3)])
def test_ssim_kernel_matches_plain(cuda_device, shape):
    x = torch.from_numpy(_clips(shape)).to(cuda_device)
    before = ssim_pair_scores.launches
    got = ssim_pair_scores(x)
    want = ssim_pair_scores_ref(x)
    torch.cuda.synchronize()
    assert ssim_pair_scores.launches == before + 1
    torch.testing.assert_close(got, want, atol=2e-6, rtol=0)


def test_ssim_kernel_scores_static_clips_one(cuda_device):
    x = torch.from_numpy(np.repeat(_clips((2, 1, 80, 80, 3)), 6, axis=1)).to(cuda_device)
    assert torch.equal(ssim_pair_scores(x), torch.ones((2, 5), device=cuda_device))


def _check_ssim_after_nan_fill(x, p=None):
    """The K4 kernel, launched just after NaN was left in every SM's shared
    memory, bit-equal to the plain version: under the plan's choice through
    ``ssim_pair_scores`` (one counted launch), or under the forced plan p."""
    before = ssim_pair_scores.launches
    _build.fill_shared_memory(float("nan"))
    if p is None:
        got = ssim_pair_scores(x)
        assert ssim_pair_scores.launches == before + 1
    else:
        got = ssim_ops._launch(x, p, ssim_ops._constants(3, 255.0))
    want = ssim_pair_scores_ref(x)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("R", [1, 5, 17])
@pytest.mark.parametrize("K", [1, 3, 7])
@pytest.mark.parametrize("W,C", [(32, 3), (43, 3)], ids=["vector", "bytes"])
def test_ssim_kernel_under_forced_plans(cuda_device, K, R, W, C):
    """Chunks of K of 11 transitions and bands of R of 17 output rows, so the
    last chunk and band are short (or, at R = H-2, one band), on the
    16-byte copy path (W*C = 96) and the byte path (W*C = 129)."""
    x = torch.from_numpy(_clips((2, 12, 19, W, C))).to(cuda_device)
    p = ssim_ops.plan(2, 12, 19, W, C, K, R)
    assert (p["chunk_pairs"], p["band_rows"]) == (K, R)
    _check_ssim_after_nan_fill(x, p)


@pytest.mark.parametrize("shape", [(2, 9, 12, 132, 1), (2, 9, 12, 258, 1), (2, 9, 12, 5, 1),
                                   (4, 19, 80, 80, 3), (2, 5, 3, 16, 1), (1, 6, 9, 128, 3),
                                   (1, 6, 9, 120, 3), (1, 9, 14, 320, 3), (1, 4, 6, 3840, 3),
                                   (1, 4, 6, 426, 3)],
                         ids=["WC132", "WC258", "WC5", "vector", "H3", "wide_vector", "wide_bytes",
                              "WC960", "WC11520", "WC1278"])
def test_ssim_kernel_byte_and_vector_paths(cuda_device, shape):
    """Row lengths off a multiple of 16 bytes take the byte path, the
    deployed frame (W*C = 240) the vector path, H=3 one output row; rows of
    384 and 360 bytes, more columns than a block's threads, take two column
    groups, each staging only the bytes it reads. Frames at their decoded
    width, 320 (UCF50), 3840 (4K) and 426 pixels (240p, the byte path), take
    4, 45 and 5 groups in the same shared memory."""
    _check_ssim_after_nan_fill(torch.from_numpy(_clips(shape)).to(cuda_device))


def test_ssim_kernel_unaligned_clips_take_the_byte_path(cuda_device):
    flat = torch.from_numpy(_clips((1 + 2 * 10 * 8 * 16 * 3,))).to(cuda_device)
    _check_ssim_after_nan_fill(flat[1:].view(2, 10, 8, 16, 3))


@pytest.mark.parametrize("L", [120, 240])
def test_ssim_kernel_one_served_video(cuda_device, L):
    """B=1, as the served path calls it: bands and short chunks, the partial
    sums added by the last block of each chunk."""
    x = torch.from_numpy(_clips((1, L, 80, 80, 3))).to(cuda_device)
    assert ssim_ops.plan(1, L, 80, 80, 3)["bands"] > 1
    _check_ssim_after_nan_fill(x)


def test_ssim_kernel_scores_all_equal_frames_exactly_one(cuda_device):
    x = torch.from_numpy(np.repeat(_clips((3, 1, 80, 80, 3)), 40, axis=1)).to(cuda_device)
    _build.fill_shared_memory(float("nan"))
    assert torch.equal(ssim_pair_scores(x), torch.ones((3, 39), device=cuda_device))


def test_ssim_kernel_on_two_streams_at_once(cuda_device):
    """Each stream has its own (clip, chunk) counters, so launches on two
    streams at once, each cut into bands, do not mix their partial sums."""
    xs = [torch.from_numpy(_clips((1, L, 80, 80, 3))).to(cuda_device) for L in (120, 240)]
    wants = [ssim_pair_scores_ref(x) for x in xs]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    outs = [[], []]
    for _ in range(20):
        for i, (s, x) in enumerate(zip(streams, xs)):
            with torch.cuda.stream(s):
                outs[i].append(ssim_pair_scores(x))
    torch.cuda.synchronize()
    assert all(torch.equal(y, w) for ys, w in zip(outs, wants) for y in ys)


def test_ssim_kernel_graph_replays_give_the_same_scores(cuda_device):
    """The (clip, chunk) counters are reset by the kernel itself, so a CUDA
    graph replayed twice gives the same, right scores."""
    x = torch.from_numpy(_clips((1, 120, 80, 80, 3))).to(cuda_device)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ssim_pair_scores(x)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y = ssim_pair_scores(x)
    graph.replay()
    first = y.clone()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(first, y) and torch.equal(y, ssim_pair_scores_ref(x))


@pytest.mark.parametrize("stats", ["identity", "imagenet"])
@pytest.mark.parametrize("shape", [(4, 6, 80, 80, 3), (3, 7, 5, 3), (2, 5, 9, 1)])
def test_normalize_kernel_matches_plain(cuda_device, shape, stats):
    x = torch.from_numpy(_clips(shape)).to(cuda_device)
    C = shape[-1]
    mean, std = (None, None) if stats == "identity" else (
        [0.485, 0.456, 0.406][:C], [0.229, 0.224, 0.225][:C])
    before = normalize_frames.launches
    got = normalize_frames(x, mean, std)
    want = normalize_frames_ref(x, mean, std)
    torch.cuda.synchronize()
    assert normalize_frames.launches == before + 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("dims", [(4, 60, 16, 32), (2, 70, 256, 16)])
def test_selective_scan_kernel_matches_plain(cuda_device, dims, reverse):
    rng = np.random.RandomState(0)
    B, L, D, N = dims
    args = [
        rng.randn(B, L, D), np.abs(rng.randn(B, L, D)) * 0.5, -np.abs(rng.randn(D, N)),
        rng.randn(B, L, N), rng.randn(B, L, N),
    ]
    args = [torch.tensor(a, dtype=torch.float32, device=cuda_device) for a in args]
    got = selective_scan(*args, reverse=reverse)
    want = selective_scan_ref(*args, reverse=reverse)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def _scan_args(B, L, D, N, device, seed=0):
    rng = np.random.RandomState(seed)
    args = [
        rng.randn(B, L, D), np.abs(rng.randn(B, L, D)) * 0.5, -np.abs(rng.randn(D, N)),
        rng.randn(B, L, N), rng.randn(B, L, N),
    ]
    return [torch.tensor(a, dtype=torch.float32, device=device) for a in args]


def _check_scan_after_nan_fill(args, reverse, code=None):
    """The kernel, launched just after NaN was left in every SM's shared
    memory, against the plain version: under the plan's choice through
    ``selective_scan`` (one counted launch), or under the packed plan
    ``code``."""
    before = selective_scan.launches
    _build.fill_shared_memory(float("nan"))
    if code is None:
        got = selective_scan(*args, reverse=reverse)
        assert selective_scan.launches == before + 1
    else:
        got = scan_ops._launch(*args, reverse, code)
    want = selective_scan_ref(*args, reverse=reverse)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("N", [1, 8, 12, 24, 32, 33, 64, 100])
def test_selective_scan_kernel_takes_every_state_size(cuda_device, N, B, reverse):
    """Every N the LRCN's hidden_size can give the scan (the sweep draws 8 to
    64), past one warp (33, 64) and past 32 lanes of 2 states (100), at the
    deployed widths."""
    _check_scan_after_nan_fill(_scan_args(B, 60, 16, N, cuda_device), reverse)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("dims", [(2, 256, 2048, 16), (3, 1, 16, 32), (1, 300, 6, 20),
                                  (1, 40, 3, 300), (32, 16, 2048, 16), (4, 16, 2048, 16)],
                         ids=["videomamba", "L1", "L300_chunks", "N300_tiles",
                              "videomamba_model_B32", "videomamba_model_B4"])
def test_selective_scan_kernel_edge_shapes(cuda_device, dims, reverse):
    """VideoMamba's width (double-buffered time chunks), one step, L past
    one chunk at a small width, N past one state tile, and the VideoMamba
    model's own shapes (T=16: the bench and train steps, a request)."""
    _check_scan_after_nan_fill(_scan_args(*dims, cuda_device), reverse)


# (S, lanes) of every kernel instance: S states a lane, lanes a channel
# (a power of two up to a warp; 64 and 96: two and three warps a channel).
_SCAN_PLANS = [(S, lanes) for S in (1, 2) for lanes in (1, 2, 4, 8, 16, 32, 64, 96)]


@pytest.mark.parametrize("S,lanes", _SCAN_PLANS)
def test_selective_scan_kernel_under_every_plan(cuda_device, S, lanes):
    """Each instance, forced, where N needs several state tiles (fewer
    lanes * S than N) or masks lanes past N, at an odd width (scalar
    copies) and over L = 37 (a padded group of steps)."""
    N = 12 if lanes < 64 else 130
    code = S | lanes << 4 | (128 // 64) << 16 | (64 // 32) << 20  # 128 threads, 64-step chunks
    assert scan_ops.decode_plan(code, N)["state_tiles"] == -(-N // (lanes * S))
    for reverse in (False, True):
        _check_scan_after_nan_fill(_scan_args(2, 37, 6, N, cuda_device), reverse, code)


@pytest.mark.parametrize("threads,chunk", [(64, 0), (256, 0), (0, 32), (256, 32), (64, 256)])
@pytest.mark.parametrize("dims", [(3, 130, 20, 32), (2, 70, 5, 100)], ids=["lanes32", "lanes128"])
def test_selective_scan_kernel_under_other_blocks_and_chunks(cuda_device, dims, threads, chunk):
    """The block sizes and chunk lengths chip_smoke times beside the plan's,
    forced, where a block holds channels past D and L takes several chunks
    (or, at 256, one)."""
    B, L, D, N = dims
    code = scan_ops.plan_code(B, D, N, 0, threads, chunk)
    got = scan_ops.decode_plan(code, N)
    assert got["block_threads"] == (threads or 128) and got["chunk_steps"] == (chunk or 64)
    for reverse in (False, True):
        _check_scan_after_nan_fill(_scan_args(*dims, cuda_device), reverse, code)


@pytest.mark.parametrize("S,threads,chunk", [(4, 0, 0), (3, 0, 0), (0, 96, 0), (0, 512, 0),
                                             (0, 0, 40), (0, 0, 288)])
def test_selective_scan_plan_refuses_what_the_kernel_does_not_take(cuda_device, S, threads,
                                                                   chunk):
    with pytest.raises(ValueError, match="no plan"):
        scan_ops.plan_code(4, 16, 32, S, threads, chunk)


@pytest.mark.parametrize("dims,S,lanes", [((32, 16, 32), 1, 32), ((4, 16, 32), 1, 32),
                                          ((2, 2048, 16), 2, 8), ((32, 32, 64), 2, 32),
                                          ((4, 16, 100), 1, 128)],
                         ids=["deployed", "served", "videomamba", "N64", "N100"])
def test_selective_scan_plan_spreads_states_as_documented(cuda_device, dims, S, lanes):
    """(B, D, N): one state a lane at the deployed shapes (a warp a channel),
    two at VideoMamba's (8 lanes a channel) and at the sweep's top N=64, and
    four warps a channel at N=100 with few channels (the plan fills the card
    before it saves lanes); 128-thread blocks and 64-step chunks."""
    got = scan_ops.plan(*dims)
    assert (got["states_per_lane"], got["lanes_per_channel"]) == (S, lanes)
    assert got["warps_per_channel"] == max(1, lanes // 32) and got["state_tiles"] == 1
    assert (got["block_threads"], got["chunk_steps"]) == (128, 64)


def _rnn_args(n_gates, B, T, H, L, device, seed=0):
    """Gate inputs and weights drawn like the model's: U(-1/sqrt(H), 1/sqrt(H))."""
    rng = np.random.RandomState(seed)
    k, GH = H ** -0.5, n_gates * H
    shapes = [(L, H, GH), (L, GH), (L - 1, H, GH), (L - 1, GH)]
    args = [rng.randn(B, T, GH)] + [rng.uniform(-k, k, s) for s in shapes]
    return [torch.tensor(a, dtype=torch.float32, device=device) for a in args]


@pytest.mark.parametrize("dims", [(4, 40, 56, 4), (3, 7, 5, 3)], ids=["served", "oddH"])
@pytest.mark.parametrize("name", ["lstm_scan", "gru_scan", "lstm_stack", "gru_stack"])
def test_rnn_kernel_matches_plain(cuda_device, name, dims):
    op = getattr(rnn_ops, name)
    n_gates = 4 if name.startswith("lstm") else 3
    xp, w_hh, b_hh, w_ih, b_ih = _rnn_args(n_gates, *dims, cuda_device)
    before = op.launches
    if name.endswith("stack"):
        got, want = op(xp, w_hh, b_hh, w_ih, b_ih), rnn_ops.stack_ref(xp, w_hh, b_hh, w_ih, b_ih)
    else:
        ref = rnn_ops.lstm_scan_ref if n_gates == 4 else rnn_ops.gru_scan_ref
        got, want = op(xp, w_hh[0], b_hh[0]), ref(xp, w_hh[0], b_hh[0])
    torch.cuda.synchronize()
    assert op.launches == before + 1
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def _check_rnn_design(name, dims, device, design, stale=None):
    """``name`` at ``dims`` takes ``design`` and agrees with its plain
    version; with ``stale``, launched just after every SM's shared memory was
    filled with that value."""
    op = getattr(rnn_ops, name)
    n_gates = 4 if name.startswith("lstm") else 3
    B, T, H, L = dims
    xp, w_hh, b_hh, w_ih, b_ih = _rnn_args(n_gates, *dims, device)
    assert rnn_ops.design(T, H, L if name.endswith("stack") else 1, n_gates) == design
    if stale is not None:
        _build.fill_shared_memory(stale)
    if name.endswith("stack"):
        got = op(xp, w_hh, b_hh, w_ih, b_ih)
        want = rnn_ops.stack_ref(xp, w_hh, b_hh, w_ih, b_ih)
    else:
        ref = rnn_ops.lstm_scan_ref if n_gates == 4 else rnn_ops.gru_scan_ref
        got, want = op(xp, w_hh[0], b_hh[0]), ref(xp, w_hh[0], b_hh[0])
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("dims", [(2, 16, 64, 4), (1, 40, 56, 4), (32, 40, 56, 4), (4, 60, 32, 3),
                                  (2, 130, 17, 3), (3, 40, 16, 4)],
                         ids=["H64", "B1", "bench", "default_width", "three_chunks", "H16"])
@pytest.mark.parametrize("name", ["lstm_scan", "gru_scan", "lstm_stack", "gru_stack"])
def test_rnn_register_design_matches_plain(cuda_device, name, dims):
    """H <= 64 takes the register design, up to its largest plan (H=64,
    L=4), over T beyond one staged chunk, and with two k-slices per gate
    column (the GRU at every width, the LSTM at H <= 16)."""
    _check_rnn_design(name, dims, cuda_device, "registers")


@pytest.mark.parametrize("dims", [(2, 40, 12, 3), (2, 40, 17, 3), (2, 130, 5, 3)],
                         ids=["H12", "H17", "H5_three_chunks"])
@pytest.mark.parametrize("name", ["lstm_scan", "gru_scan", "lstm_stack", "gru_stack"])
def test_rnn_register_design_reads_no_stale_shared_memory(cuda_device, name, dims):
    """Widths whose rows of h are padded in shared memory (H not a multiple
    of 4 * slices), launched after a kernel that left NaN in every SM's
    shared memory: the padding is read as zeros, so the result is finite and
    agrees."""
    _check_rnn_design(name, dims, cuda_device, "registers", stale=float("nan"))


@pytest.mark.parametrize("H,design", [(65, "clusters"), (96, "clusters"), (97, "clusters"),
                                      (128, "clusters"), (256, "clusters"), (257, "columns")])
@pytest.mark.parametrize("name", ["lstm_scan", "gru_scan", "lstm_stack", "gru_stack"])
def test_rnn_columns_design_above_64(cuda_device, name, H, design):
    """Above H = 64: "clusters" up to its widest, H = 256 (H_max), H not a
    multiple of the cluster's 8 or 16 CTAs included; "columns" above."""
    _check_rnn_design(name, (2, 16, H, 2), cuda_device, design, stale=float("nan"))


@pytest.mark.parametrize("dims", [(2, 16, 320, 2), (1, 128, 512, 2)],
                         ids=["weights_in_L2", "seq_in_L2"])
@pytest.mark.parametrize("name", ["lstm_stack", "gru_stack"])
def test_rnn_stack_kernel_reads_through_l2(cuda_device, name, dims):
    """"columns" (above H_max = 256) reads every weight through L2, and the
    previous layer's outputs too where they do not fit shared memory."""
    _check_rnn_design(name, dims, cuda_device, "columns")


# "clusters" shapes (B, T, H, L): H = 65, 97 (not a multiple of the
# cluster's CTAs), 128 and 256 (H_max); rows left over in the last cluster
# (B = 3 at two rows a cluster, B = 33 at four); T beyond one staged chunk
# (the next layer's inputs read back from y); the bench width at B = 32.
_CLUSTER_DIMS = [(3, 20, 65, 3), (5, 20, 97, 2), (4, 40, 128, 4), (2, 16, 256, 2),
                 (33, 12, 256, 2), (2, 150, 128, 2), (3, 40, 256, 2), (32, 40, 128, 4)]
_CLUSTER_IDS = ["H65", "H97", "H128", "H256", "H256_B33", "H128_T150", "H256_T40", "H128_B32"]


@pytest.mark.parametrize("dims", _CLUSTER_DIMS, ids=_CLUSTER_IDS)
@pytest.mark.parametrize("name", ["lstm_scan", "gru_scan", "lstm_stack", "gru_stack"])
def test_rnn_cluster_design_matches_plain(cuda_device, name, dims):
    """"clusters" against the plain version, each launch after NaN was left
    in every SM's shared memory (the padding of h's rows and the peers'
    buffers read as zeros)."""
    _check_rnn_design(name, dims, cuda_device, "clusters", stale=float("nan"))


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_rnn_cluster_design_through_the_flip(cuda_device, cell):
    """K5 on time-flipped inputs, as a bidirectional layer's reverse
    direction runs it, at the H = 128 phase's width."""
    n_gates = 4 if cell == "lstm" else 3
    xp, w_hh, b_hh, _, _ = _rnn_args(n_gates, 8, 40, 128, 2, cuda_device)
    flip = torch.flip(xp, dims=(1,))
    ref = rnn_ops.lstm_scan_ref if n_gates == 4 else rnn_ops.gru_scan_ref
    _build.fill_shared_memory(float("nan"))
    got = torch.flip(getattr(rnn_ops, f"{cell}_scan")(flip, w_hh[1], b_hh[1]), dims=(1,))
    want = torch.flip(ref(flip, w_hh[1], b_hh[1]), dims=(1,))
    torch.cuda.synchronize()
    assert rnn_ops.design(40, 128, 1, n_gates) == "clusters"
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("H", [65, 128, 256])
@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_rnn_cluster_every_plan_matches_plain(cuda_device, cell, H):
    """Every plan the kernels take, (8 or 16 CTAs a cluster, 1, 2 or 4
    rows), forward and one backward layer, at B = 9 (a part-filled last
    cluster), each after the NaN fill, against the plain versions."""
    n_gates = 4 if cell == "lstm" else 3
    B, T = 9, 20
    args = _rnn_args(n_gates, B, T, H, 2, cuda_device)
    want = rnn_ops.stack_ref(*args)
    GH = n_gates * H
    gen = _gen(cuda_device, H)
    x = torch.randn(B, T, GH, device=cuda_device, generator=gen)
    h = torch.randn(B, T, H, device=cuda_device, generator=gen).tanh()
    w_hh = args[1][0]
    bx, b_hh = torch.randn(2, GH, device=cuda_device, generator=gen) * 0.1
    r, dy = h @ w_hh, torch.randn(B, T, H, device=cuda_device, generator=gen)
    ref = [torch.empty_like(x), torch.empty_like(x), x.new_empty(2, B, GH)]
    rnn_ops.layer_bwd_ref(n_gates, x, r, bx, b_hh, h, w_hh, dy, *ref)
    for cluster in (8, 16):
        if -(-H // cluster) > 16:
            continue
        for rows in (1, 2, 4):
            _build.fill_shared_memory(float("nan"))
            got, _, _ = rnn_ops._launch(f"{cell}_stack", n_gates, *args, cluster=(cluster, rows))
            torch.cuda.synchronize()
            torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
            out = [torch.empty_like(t) for t in ref]
            _build.fill_shared_memory(float("nan"))
            rnn_ops._layer_bwd(n_gates, x, r, bx, b_hh, h, w_hh, dy, *out, cluster=(cluster, rows))
            torch.cuda.synchronize()
            _assert_grads_close(out, ref, ("x", "R", "b"))


def test_rnn_cluster_plan_is_pinned(cuda_device):
    """The plan by the shapes: 8 CTAs a cluster up to H = 128, 16 above; one
    row a cluster while the batch's clusters fit the card at once (30 of 8
    up to H = 96, two CTAs an SM; 15 of 8 and 7 of 16 above), then two or
    four, two where none fits; the card holds the plan's clusters where
    they fit."""
    cases = {(2, 256): (16, 1), (32, 65): (8, 2), (30, 96): (8, 1), (32, 128): (8, 4),
             (28, 256): (16, 4), (4, 128): (8, 1), (16, 97): (8, 2), (15, 97): (8, 1),
             (32, 256): (16, 2)}
    for (B, H), (cluster, rows) in cases.items():
        for backward in (False, True):
            got = rnn_ops.plan(B, 40, H, 2, 4, backward=backward)
            assert (got["cluster"], got["rows"]) == (cluster, rows), (B, H)
            assert got["resident"] >= min(got["clusters"], 7), (B, H, got)
    assert rnn_ops.plan(32, 40, 64, 2, 4) is None and rnn_ops.plan(32, 40, 257, 2, 3) is None


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_rnn_cluster_runs_and_graph_replay_are_bit_equal(cuda_device, cell):
    """The H = 128 stack's forward and backward twice and replayed from a
    CUDA graph, each after a NaN fill: a fixed summation order, no atomics."""
    n_gates = 4 if cell == "lstm" else 3
    args = _rnn_args(n_gates, 32, 40, 128, 4, cuda_device)
    gy = torch.randn(32, 40, 128, device=cuda_device, generator=_gen(cuda_device))
    bwd = getattr(rnn_ops, f"{cell}_stack_bwd")

    def step():
        y, hs, _ = rnn_ops._launch(f"{cell}_stack", n_gates, *args, save=True)
        return (y, hs, *bwd(*args, hs, y, gy))

    runs = []
    for _ in range(2):
        _build.fill_shared_memory(float("nan"))
        runs.append([t.clone() for t in step()])
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = step()
    _build.fill_shared_memory(float("nan"))
    graph.replay()
    torch.cuda.synchronize()
    runs.append([t.clone() for t in out])
    assert all(torch.equal(a, b) for run in runs[1:] for a, b in zip(runs[0], run))


def test_kernel_wrappers_refuse_what_they_cannot_take(cuda_device):
    x = torch.from_numpy(_clips((2, 5, 8, 8, 3))).to(cuda_device)
    with pytest.raises(TypeError):
        pair_scores(x.to(torch.int32))
    with pytest.raises(ValueError):
        pair_scores(x.transpose(2, 3))
    with pytest.raises(TypeError):
        ssim_pair_scores(x.to(torch.int32))
    with pytest.raises(ValueError):
        ssim_pair_scores(x.transpose(2, 3))
    with pytest.raises(ValueError, match="win"):
        ssim_pair_scores(x, win=5)
    with pytest.raises(TypeError):
        normalize_frames(x.to(torch.int32))
    with pytest.raises(ValueError):
        normalize_frames(x.transpose(2, 3))
    gen = _gen(cuda_device)
    args = [torch.rand(2, 5, 8, device=cuda_device, generator=gen)] * 2 + [
        -torch.rand(8, 12, device=cuda_device, generator=gen),
        torch.rand(2, 5, 12, device=cuda_device, generator=gen),
        torch.rand(2, 5, 12, device=cuda_device, generator=gen),
    ]
    torch.testing.assert_close(selective_scan(*args), selective_scan_ref(*args),
                               atol=1e-5, rtol=1e-5)  # N=12: every N runs
    with pytest.raises(TypeError):
        selective_scan(*[a.double() for a in args])
    with pytest.raises(ValueError, match="contiguous"):
        selective_scan(args[0], args[1], args[2].t().contiguous().t(), *args[3:])
    with pytest.raises(ValueError, match="is on"):
        selective_scan(*args[:4], args[4].cpu())
    xp, w_hh, b_hh, w_ih, b_ih = _rnn_args(4, 2, 3, 8, 2, cuda_device)
    with pytest.raises(TypeError):
        rnn_ops.lstm_scan(xp.double(), w_hh[0].double(), b_hh[0].double())
    with pytest.raises(ValueError, match="contiguous"):
        rnn_ops.lstm_stack(xp.transpose(0, 1).contiguous().transpose(0, 1), w_hh, b_hh, w_ih, b_ih)
    with pytest.raises(ValueError, match="is on"):
        rnn_ops.lstm_stack(xp, w_hh.cpu(), b_hh, w_ih, b_ih)


def test_small_serving_path_goes_through_the_kernels(cuda_device):
    T = 4
    cfg = ModelConfig(num_classes=3, cnn_backbone="resnet18", scan_impl="pallas")
    model = build_model(cfg, T, seed=0)
    videos = [_clips((n, 16, 16, 3), seed=n) for n in (3, 7, 12)]
    pair_scores.launches = selective_scan.launches = 0
    clips = sample_decoded_clips(videos, "sad", T)
    probs = classify_videos(model, clips, batch_size=2)
    assert pair_scores.launches == 2  # the two videos longer than T
    assert selective_scan.launches == 2 * cfg.rnn_layer  # two forwards
    assert probs.shape == (3, 3) and np.isfinite(probs).all()
    np.testing.assert_allclose(probs.sum(-1), 1.0, rtol=1e-5)
    with torch.inference_mode():
        want = model.to("cpu")(clips.cpu())
        got = model.to(cuda_device)(clips)
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)
    idx_cpu = preprocess.sample_indices(torch.from_numpy(_clips((2, 12, 16, 16, 3))), T, "sad")
    idx_gpu = preprocess.sample_indices(torch.from_numpy(_clips((2, 12, 16, 16, 3))).to(cuda_device), T, "sad")
    assert torch.equal(idx_cpu, idx_gpu.cpu())


def test_mamba_hidden_24_serves_through_the_kernel(cuda_device):
    """A Mamba LRCN of hidden_size 24 (so n_state = 24, a state size the
    kernel once refused) serves through K3; logits match the CPU's."""
    T = 4
    cfg = ModelConfig(num_classes=3, cnn_backbone="resnet18", rnn_input_size=8, hidden_size=24,
                      scan_impl="pallas")
    model = build_model(cfg, T, seed=0)
    videos = [_clips((n, 16, 16, 3), seed=n) for n in (3, 7, 12)]
    selective_scan.launches = 0
    clips = sample_decoded_clips(videos, "sad", T)
    probs = classify_videos(model, clips, batch_size=2)
    assert selective_scan.launches == 2 * cfg.rnn_layer  # two forwards
    assert probs.shape == (3, 3) and np.isfinite(probs).all()
    with torch.inference_mode():
        want = model.to("cpu")(clips.cpu())
        got = model.to(cuda_device)(clips)
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)


_ZOO_CASES = [("videomamba", {}), ("lrcn2", {}), ("td_cnn_lstm", {})] + [
    ("lrcn", {"cnn_backbone": b}) for b in ("mobilenet_v2", "efficientnet_b0", "densenet121",
                                            "vgg16", "alexnet", "inception_v3")]


@pytest.mark.parametrize("family,model", _ZOO_CASES,
                         ids=[m.get("cnn_backbone", f) for f, m in _ZOO_CASES])
def test_new_families_build_and_forward_on_the_card(cuda_device, family, model):
    """Each family and backbone of the zoo built on the card by default
    (VideoMamba at vct's full width; the LRCNs the deployed Mamba head),
    forward on two 80x80 clips: K3 a Mamba block a forward, no launch on the
    scratch CNNs' plain recurrences, and logits within atol = rtol = 1e-3 of
    the same seeded model on the CPU (f32, TF32 off: the card's and the
    CPU's convolutions sum in other orders)."""
    T = 8
    cfg = ModelConfig(model_family=family, scan_impl="pallas", **model)
    net = build_model(cfg, T, seed=3, frame_size=(80, 80))
    assert next(net.parameters()).device.type == "cuda"
    x = torch.rand(2, T, 80, 80, 3, generator=torch.Generator().manual_seed(0))
    selective_scan.launches = 0
    with torch.inference_mode():
        got = net(x.to(cuda_device))
        torch.cuda.synchronize()
        want = build_model(cfg, T, device="cpu", seed=3, frame_size=(80, 80))(x)
    blocks = {"videomamba": cfg.vm_n_layer, "lrcn": cfg.rnn_layer}.get(family, 0)
    assert selective_scan.launches == blocks
    assert got.shape == (2, cfg.num_classes) and bool(torch.isfinite(got).all())
    torch.testing.assert_close(got.cpu(), want, atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("rnn_type,bidirectional", [("lstm", False), ("gru", True)])
def test_recurrent_serving_path_goes_through_the_kernels(cuda_device, rnn_type, bidirectional):
    T, layers = 4, 2
    cfg = ModelConfig(num_classes=3, cnn_backbone="resnet18", rnn_type=rnn_type,
                      rnn_input_size=8, hidden_size=6, rnn_layer=layers,
                      bidirectional=bidirectional, scan_impl="pallas")
    model = build_model(cfg, T, seed=0)
    videos = [_clips((n, 16, 16, 3), seed=n) for n in (3, 7, 12)]
    ops = [rnn_ops.lstm_scan, rnn_ops.gru_scan, rnn_ops.lstm_stack, rnn_ops.gru_stack]
    for op in ops:
        op.launches = 0
    clips = sample_decoded_clips(videos, "sad", T)
    probs = classify_videos(model, clips, batch_size=2)  # two forwards
    launches = {op.__name__: op.launches for op in ops}
    want = dict.fromkeys(launches, 0)
    if bidirectional:
        want[f"{rnn_type}_scan"] = 2 * 2 * layers  # forwards x directions x layers
    else:
        want[f"{rnn_type}_stack"] = 2  # one per forward
    assert launches == want
    assert probs.shape == (3, 3) and np.isfinite(probs).all()
    with torch.inference_mode():
        want_logits = model.to("cpu")(clips.cpu())
        got = model.to(cuda_device)(clips)
    torch.testing.assert_close(got.cpu(), want_logits, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("sampling", ["ssim", "ssim_most_unique"])
def test_ssim_serving_path_goes_through_the_kernel(cuda_device, sampling):
    T = 4
    cfg = ModelConfig(num_classes=3, cnn_backbone="resnet18", scan_impl="pallas")
    model = build_model(cfg, T, seed=0)
    videos = [_clips((n, 16, 16, 3), seed=n) for n in (3, 7, 12)]
    ssim_pair_scores.launches = pair_scores.launches = selective_scan.launches = 0
    clips = sample_decoded_clips(videos, sampling, T)
    probs = classify_videos(model, clips, batch_size=4)
    assert ssim_pair_scores.launches == 2  # the two videos longer than T
    assert pair_scores.launches == 0
    assert selective_scan.launches == cfg.rnn_layer  # one forward
    assert probs.shape == (3, 3) and np.isfinite(probs).all()
    torch.testing.assert_close(clips.cpu(), sample_decoded_clips(videos, sampling, T, device="cpu"),
                               rtol=1e-6, atol=0)
    raw = torch.from_numpy(_clips((2, 12, 16, 16, 3)))
    idx_cpu = preprocess.sample_indices(raw, T, "ssim")
    assert torch.equal(idx_cpu, preprocess.sample_indices(raw.to(cuda_device), T, "ssim").cpu())


# --- backward kernels -------------------------------------------------------
# Each gradient within 1e-5 of its largest magnitude of autograd through the
# plain version (f32, other summation orders; 4e-7 of it measured on the
# card), every backward launch after a NaN fill of shared memory.
BWD_RTOL = 1e-5


def _assert_grads_close(got, want, names, floors=None):
    """Each gradient within BWD_RTOL of its largest magnitude; where
    ``floors`` gives a gradient a tensor of per-element bounds, each element
    within the larger of the two."""
    for name, g, w in zip(names, got, want):
        assert g is not None, name
        err, scale = (g - w).abs(), w.abs().max().item()
        floor = (floors or {}).get(name)
        if floor is None:
            assert err.max().item() <= BWD_RTOL * scale, \
                f"d{name}: {err.max().item()} against {BWD_RTOL} x {scale}"
        else:
            over = err / floor.clamp(min=BWD_RTOL * scale)
            assert over.max().item() <= 1.0, \
                f"d{name}: {over.max().item()} x the larger of {BWD_RTOL} x {scale} and its floor"


def _stale(fn):
    def wrapped(*args):
        _build.fill_shared_memory(float("nan"))
        return fn(*args)
    return wrapped


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("dims", [(4, 60, 16, 32), (3, 70, 20, 1), (2, 33, 5, 24), (2, 40, 16, 33),
                                  (2, 20, 6, 100), (2, 130, 16, 32), (2, 256, 64, 16),
                                  (2, 40, 6, 300), (1, 60, 16, 32), (3, 60, 20, 32),
                                  (32, 16, 2048, 16), (4, 16, 2048, 16)],
                         ids=["deployed", "N1", "N24", "N33", "N100", "L130", "videomamba_L_N",
                              "N300", "B1", "D20", "videomamba_model_B32",
                              "videomamba_model_B4"])
def test_selective_scan_backward_kernel_matches_plain(cuda_device, dims, reverse):
    args = _scan_args(*dims, cuda_device)
    gy = torch.randn(dims[:3], device=cuda_device, generator=_gen(cuda_device))
    leaves = [a.clone().requires_grad_(True) for a in args]
    y = selective_scan(*leaves, reverse=reverse)
    before = scan_ops.selective_scan_bwd.launches
    _build.fill_shared_memory(float("nan"))
    got = torch.autograd.grad(y, leaves, gy)
    torch.cuda.synchronize()
    assert scan_ops.selective_scan_bwd.launches == before + 1
    _assert_grads_close(got, scan_ops.selective_scan_bwd_ref(*args, gy, reverse=reverse),
                        "u delta A B C".split())
    again = scan_ops.selective_scan_bwd(*args, gy, reverse=reverse)
    assert all(torch.equal(a, b) for a, b in zip(got, again))  # two runs bit-equal


def test_selective_scan_backward_counters_reset_across_shapes_and_graph_replays(cuda_device):
    """Two shapes, each with its own tree of channel-group partials and
    counters, alternate on one stream; then both are captured in one CUDA
    graph and replayed twice. Every result is bit-equal to the first run of
    its shape: each launch leaves its counters at zero for the next."""
    shapes = [(32, 60, 16, 32), (3, 130, 40, 24)]
    cases = []
    for i, dims in enumerate(shapes):
        args = _scan_args(*dims, cuda_device, seed=i)
        cases.append((args, torch.randn(dims[:3], device=cuda_device,
                                        generator=_gen(cuda_device, seed=i))))
    first = [[t.clone() for t in scan_ops.selective_scan_bwd(*a, gy)] for a, gy in cases]
    for _ in range(2):
        for (a, gy), want in zip(cases, first):
            _build.fill_shared_memory(float("nan"))
            got = scan_ops.selective_scan_bwd(*a, gy)
            assert all(torch.equal(x, y) for x, y in zip(got, want))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for a, gy in cases:
            scan_ops.selective_scan_bwd(*a, gy)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [scan_ops.selective_scan_bwd(*a, gy) for a, gy in cases]
    for _ in range(2):
        for out in outs:
            for t in out:
                t.fill_(float("nan"))
        _build.fill_shared_memory(float("nan"))
        graph.replay()
        torch.cuda.synchronize()
        for out, want in zip(outs, first):
            assert all(torch.equal(x, y) for x, y in zip(out, want))


def test_selective_scan_backward_plan_is_pinned(cuda_device):
    """The backward's plan at the deployed step (one state a lane, a warp a
    channel, one 64-step chunk) and at VideoMamba's shape (two states a
    lane, eight lanes a channel, 64-step chunks), 128-thread blocks."""
    deployed = scan_ops.bwd_plan(32, 60, 16, 32)
    assert (deployed["states_per_lane"], deployed["lanes_per_channel"], deployed["block_threads"],
            deployed["chunk_steps"], deployed["state_tiles"]) == (1, 32, 128, 64, 1)
    videomamba = scan_ops.bwd_plan(2, 256, 2048, 16)
    assert (videomamba["states_per_lane"], videomamba["lanes_per_channel"],
            videomamba["block_threads"], videomamba["chunk_steps"],
            videomamba["state_tiles"]) == (2, 8, 128, 64, 1)
    assert scan_ops.bwd_plan(4, 60, 16, 300)["state_tiles"] == 2


@pytest.mark.parametrize("dims", [(4, 40, 56, 4), (3, 7, 5, 3), (2, 20, 17, 3), (2, 16, 65, 2),
                                  (2, 16, 256, 2)], ids=["served", "H5", "H17", "H65", "H256"])
@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_rnn_backward_kernels_match_plain(cuda_device, monkeypatch, cell, dims):
    """K2's backward (a launch a layer) and K5's (the one-layer case),
    against autograd through the plain versions."""
    monkeypatch.setattr(rnn_ops, "_layer_bwd", _stale(rnn_ops._layer_bwd))
    n_gates = 4 if cell == "lstm" else 3
    args = _rnn_args(n_gates, *dims, cuda_device)
    gy = torch.randn(dims[:3], device=cuda_device, generator=_gen(cuda_device))
    stack_bwd = getattr(rnn_ops, f"{cell}_stack_bwd")
    leaves = [a.clone().requires_grad_(True) for a in args]
    before = stack_bwd.launches
    got = torch.autograd.grad(getattr(rnn_ops, f"{cell}_stack")(*leaves), leaves, gy)
    torch.cuda.synchronize()
    assert stack_bwd.launches == before + dims[3]
    _assert_grads_close(got, rnn_ops.stack_bwd_ref(*args, gy), ("xp0", "w_hh", "b_hh", "w_ih",
                                                                 "b_ih"))
    layer = [args[0], args[1][0], args[2][0]]
    leaves = [a.clone().requires_grad_(True) for a in layer]
    scan_bwd = getattr(rnn_ops, f"{cell}_scan_bwd")
    before = scan_bwd.launches
    got = torch.autograd.grad(getattr(rnn_ops, f"{cell}_scan")(*leaves), leaves, gy)
    torch.cuda.synchronize()
    assert scan_bwd.launches == before + 1
    _assert_grads_close(got, rnn_ops.scan_bwd_ref(*layer, gy), ("xp", "w_hh", "b_hh"))
    y, _, _ = rnn_ops._launch(f"{cell}_scan", n_gates, *layer)
    assert all(torch.equal(a, b) for a, b in zip(got, scan_bwd(*layer, y, gy)))


F32_UNIT = 2.0 ** -24  # f32's unit roundoff


def _dw_hh_terms(args, gy):
    """Per layer and element of dw_hh, the sum over (b, t) of the magnitudes
    of the B·T products it adds up, |h_{t-1}| |g_t|, in float64: g_t is the
    gradient of the step's h_{t-1} @ w_hh + b_hh, the gate input's for the
    LSTM, and for the GRU the same with the new gate's third times r."""
    xp0, w_hh, b_hh, w_ih, b_ih = [a.double() for a in args]
    L, H, GH = w_hh.shape
    ref = rnn_ops.lstm_scan_ref if GH == 4 * H else rnn_ops.gru_scan_ref
    buf, layers = xp0.clone().requires_grad_(True), []
    for l in range(L):
        buf.retain_grad()
        y = ref(buf, w_hh[l], b_hh[l])
        layers.append((buf, y))
        if l < L - 1:
            buf = y @ w_ih[l] + b_ih[l]
    y.backward(gy.double())
    sums = []
    for l, (x, y) in enumerate(layers):
        prev = torch.cat([torch.zeros_like(y[:, :1]), y[:, :-1]], 1).detach()
        g = x.grad.clone()
        if GH == 3 * H:  # n = tanh(xn + r * hn)
            g[..., 2 * H:] *= torch.sigmoid(x.detach()[..., :H] + prev @ w_hh[l][:, :H]
                                            + b_hh[l][:H])
        sums.append(torch.einsum("bti,btj->ij", prev.abs(), g.abs()))
    return torch.stack(sums)


def _check_rnn_backward(cell, dims, device, gy=None):
    """K2's backward (a stack of dims[3] layers) and K5's (its first layer)
    through autograd, and the plain versions in f32, each held against the
    plain versions in float64; ``gy`` from a seeded generator unless given.
    Every gradient within BWD_RTOL of its largest magnitude, but dw_hh
    elementwise within the larger of that and f32's rounding bound for a sum
    of n = B·T products, n u times the sum of their magnitudes: at H = 1
    dw_hh cancels to a few 1e-3 of its terms, and BWD_RTOL of its largest
    lies below that bound (see ``_LSTM1_DRAWS``)."""
    n_gates = 4 if cell == "lstm" else 3
    args = _rnn_args(n_gates, *dims, device)
    if gy is None:
        gy = torch.randn(dims[:3], device=device, generator=_gen(device))
    n_terms = dims[0] * dims[1]
    leaves = [a.clone().requires_grad_(True) for a in args]
    got = torch.autograd.grad(getattr(rnn_ops, f"{cell}_stack")(*leaves), leaves, gy)
    torch.cuda.synchronize()
    names = ("xp0", "w_hh", "b_hh", "w_ih", "b_ih")
    want = rnn_ops.stack_bwd_ref(*[a.double() for a in args], gy.double())
    floors = {"w_hh": n_terms * F32_UNIT * _dw_hh_terms(args, gy)}
    _assert_grads_close(got, want, names, floors)
    _assert_grads_close(rnn_ops.stack_bwd_ref(*args, gy), want, names, floors)
    layer = [args[0], args[1][0], args[2][0]]
    leaves = [a.clone().requires_grad_(True) for a in layer]
    got = torch.autograd.grad(getattr(rnn_ops, f"{cell}_scan")(*leaves), leaves, gy)
    torch.cuda.synchronize()
    want = rnn_ops.scan_bwd_ref(*[a.double() for a in layer], gy.double())
    floors = {"w_hh": n_terms * F32_UNIT * _dw_hh_terms(
        [args[0], args[1][:1], args[2][:1], args[3][:0], args[4][:0]], gy)[0]}
    _assert_grads_close(got, want, ("xp", "w_hh", "b_hh"), floors)
    _assert_grads_close(rnn_ops.scan_bwd_ref(*layer, gy), want, ("xp", "w_hh", "b_hh"), floors)


# Two draws of gy at (3, 20, 1, 3), the 161st and the 442nd of a CUDA
# generator seeded 0, as f32 bits. On draw 160 dw_hh by the kernel lies
# 2.00 x BWD_RTOL of its largest from the float64 plain version, and the
# f32 plain version's (cuBLAS) 3.24 x; on draw 441 the two f32 results lie
# 1.50 x the limit apart, each within it of float64 (0.62 and 0.88). dw_hh at
# H = 1 sums B·T = 60 products that cancel down to a few 1e-3 of their
# magnitudes, and both f32 sums keep within 7.5 u of that magnitude, where
# the bound is 60 u (``python tests/torch_rnn_bwd_rounding.py`` on an NVIDIA
# H100 80GB HBM3, 1000 draws).
_LSTM1_DRAWS = {
    "draw160": (
        "-0x1.5374fap-3", "0x1.117feep-1", "0x1.0da982p-1", "-0x1.92bd94p-1", "-0x1.1dfc2ap-1",
        "-0x1.5ff5dep+1", "-0x1.7e4bbap+0", "-0x1.f5b012p-2", "0x1.2f8df2p+0", "-0x1.eb77c2p-2",
        "-0x1.3cf434p-2", "-0x1.d6120cp-2", "-0x1.41bcp-3", "-0x1.31e5fep-6", "-0x1.6eeaa6p-5",
        "-0x1.306494p+0", "-0x1.96f296p-1", "0x1.29da1ap-1", "0x1.fa4956p-3", "0x1.e5699cp-4",
        "0x1.0a986p+0", "0x1.20e5ecp-1", "0x1.51b342p+0", "-0x1.a39c34p-5", "0x1.9183b2p-1",
        "0x1.67b09cp-1", "-0x1.f64802p-2", "-0x1.19e618p-1", "0x1.a204f6p-2", "0x1.81235ap-2",
        "-0x1.271a74p+1", "-0x1.aa8206p-1", "0x1.19c2dp+0", "0x1.982276p-1", "0x1.e0cabcp+0",
        "-0x1.9f321ep-2", "0x1.171ef8p+1", "-0x1.cd922p-1", "0x1.55da38p-4", "0x1.ea0406p-1",
        "-0x1.b9e016p-1", "0x1.0f6956p-1", "-0x1.64f28p+1", "-0x1.5130c8p-2", "0x1.18c04p+0",
        "0x1.0a8ccap+0", "0x1.2cf586p+0", "-0x1.832308p+0", "-0x1.9cf552p-1", "0x1.0b070ep+1",
        "0x1.60b71ap-4", "-0x1.d6cde8p-3", "0x1.44c5bcp+0", "-0x1.e4c22ap-3", "-0x1.3c519ap-1",
        "0x1.3be55ep+0", "-0x1.899ec4p-3", "-0x1.9cb646p+0", "0x1.c98be6p-1", "-0x1.a765c8p-4",
    ),
    "draw441": (
        "-0x1.3452cap+1", "-0x1.e488cap-1", "0x1.03746ap-1", "-0x1.2f5db6p+1", "-0x1.7944bep-4",
        "0x1.ea9c8ep-2", "-0x1.f40b4cp+0", "-0x1.09258ap+0", "0x1.a70442p-1", "0x1.62b768p-1",
        "-0x1.4d4ad6p-1", "0x1.22860ep-3", "-0x1.2a1bdep+0", "0x1.0dde1cp-1", "0x1.7d99c2p+1",
        "-0x1.bde922p-2", "0x1.1dd006p-1", "0x1.3a5f1ap+0", "-0x1.30af52p-3", "-0x1.9b983ep-1",
        "-0x1.22c43ap+1", "0x1.a71c28p+0", "0x1.a05cdcp-1", "0x1.a2ad38p-2", "-0x1.1d9e98p-1",
        "-0x1.bb7a1ap-1", "-0x1.fcffbcp+0", "0x1.0b4f5cp-2", "-0x1.a16764p-1", "-0x1.4f11b2p-5",
        "-0x1.2aff16p+0", "0x1.c6ad82p-1", "0x1.3f83bp-5", "-0x1.a178aap-1", "-0x1.0e49b2p+0",
        "-0x1.37582ep-4", "-0x1.33a03p+0", "0x1.32b78ep-2", "0x1.049d74p+0", "-0x1.c31514p-1",
        "-0x1.8e44c8p+0", "0x1.199394p-1", "-0x1.5f0658p-1", "0x1.4ced1ep-1", "0x1.fb6c5ap-4",
        "-0x1.16d542p+0", "0x1.028216p-1", "0x1.71d8ap-1", "0x1.e6661ap-2", "0x1.83e958p-1",
        "-0x1.be73dcp-2", "0x1.0bb7c4p+0", "0x1.2e93fcp-2", "0x1.1689b2p+0", "-0x1.457ce2p-1",
        "-0x1.5dfeep+0", "0x1.c4b28ep+0", "0x1.147dp+0", "-0x1.5bf9d4p-1", "0x1.c670aep+0",
    ),
}


@pytest.mark.parametrize("H", [1, 5, 16, 17, 33, 56, 64])
@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_rnn_backward_register_design_matches_plain(cuda_device, monkeypatch, cell, H):
    """The register backward at widths from one unit to its widest plan,
    odd ones included (dpre rows padded in shared memory), stack and one
    layer, each launch after NaN was left in every SM's shared memory."""
    monkeypatch.setattr(rnn_ops, "_layer_bwd", _stale(rnn_ops._layer_bwd))
    assert rnn_ops.bwd_design(20, H, 4 if cell == "lstm" else 3) == "registers"
    _check_rnn_backward(cell, (3, 20, H, 3), cuda_device)


@pytest.mark.parametrize("draw", sorted(_LSTM1_DRAWS))
def test_rnn_backward_register_design_on_a_draw_that_parted_kernel_and_plain(cuda_device,
                                                                             monkeypatch, draw):
    """``_LSTM1_DRAWS``, cases of their own: the kernel and the f32 plain
    version each held against the float64 plain version."""
    monkeypatch.setattr(rnn_ops, "_layer_bwd", _stale(rnn_ops._layer_bwd))
    gy = torch.tensor([float.fromhex(v) for v in _LSTM1_DRAWS[draw]]).reshape(3, 20, 1)
    _check_rnn_backward("lstm", (3, 20, 1, 3), cuda_device, gy.to(cuda_device))


@pytest.mark.parametrize("H", [17, 64])
@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_rnn_backward_register_design_over_chunks(cuda_device, monkeypatch, cell, H):
    """T = 130: three staged chunks of steps, the LSTM's c at each later
    chunk's start walked before the first."""
    monkeypatch.setattr(rnn_ops, "_layer_bwd", _stale(rnn_ops._layer_bwd))
    _check_rnn_backward(cell, (2, 130, H, 2), cuda_device)


def test_rnn_backward_design_is_pinned(cuda_device):
    """"registers" at every H <= 64, "clusters" at every 64 < H <= 256,
    "columns" above; the forward's the same (for a stack and for K5)."""
    for n_gates in (4, 3):
        for H in range(1, 65):
            assert rnn_ops.bwd_design(40, H, n_gates) == "registers", H
        for H in range(65, 257):
            assert rnn_ops.bwd_design(40, H, n_gates) == "clusters", H
            assert rnn_ops.design(40, H, 4, n_gates) == rnn_ops.design(40, H, 1, n_gates) \
                == "clusters", H
        for H in (257, 512, 2048):
            assert rnn_ops.bwd_design(40, H, n_gates) == "columns", H
            assert rnn_ops.design(40, H, 2, n_gates) == "columns", H


@pytest.mark.parametrize("dims", [(3, 20, 65, 3), (5, 20, 97, 2), (2, 20, 128, 2), (2, 16, 256, 3),
                                  (33, 12, 256, 2), (2, 130, 128, 2), (9, 70, 256, 2)],
                         ids=["H65", "H97", "H128", "H256", "H256_B33", "H128_T130",
                              "H256_T70"])
@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_rnn_backward_cluster_design_matches_plain(cuda_device, monkeypatch, cell, dims):
    """The "clusters" backward at H = 65, 97 (not a multiple of the
    cluster's CTAs), 128 and 256 (H_max), with rows left over in the last
    cluster and over several staged chunks (the LSTM's c walked forward
    first), stack and one layer, each launch after NaN was left in every
    SM's shared memory."""
    monkeypatch.setattr(rnn_ops, "_layer_bwd", _stale(rnn_ops._layer_bwd))
    assert rnn_ops.bwd_design(dims[1], dims[2], 4 if cell == "lstm" else 3) == "clusters"
    _check_rnn_backward(cell, dims, cuda_device)


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_rnn_backward_columns_above_h_max(cuda_device, monkeypatch, cell):
    """"columns" above H_max, forward and backward, after the NaN fill."""
    monkeypatch.setattr(rnn_ops, "_layer_bwd", _stale(rnn_ops._layer_bwd))
    assert rnn_ops.bwd_design(12, 272, 4 if cell == "lstm" else 3) == "columns"
    _check_rnn_backward(cell, (2, 12, 272, 2), cuda_device)


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_rnn_backward_runs_and_graph_replay_are_bit_equal(cuda_device, cell):
    """The bench stack's backward twice and replayed from a CUDA graph, each
    after a NaN fill: fixed summation orders, no atomics."""
    n_gates = 4 if cell == "lstm" else 3
    args = _rnn_args(n_gates, 32, 40, 56, 4, cuda_device)
    gy = torch.randn(32, 40, 56, device=cuda_device, generator=_gen(cuda_device))
    y, hs, _ = rnn_ops._launch(f"{cell}_stack", n_gates, *args, save=True)
    bwd = getattr(rnn_ops, f"{cell}_stack_bwd")
    runs = []
    for _ in range(2):
        _build.fill_shared_memory(float("nan"))
        runs.append([t.clone() for t in bwd(*args, hs, y, gy)])
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        bwd(*args, hs, y, gy)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = bwd(*args, hs, y, gy)
    _build.fill_shared_memory(float("nan"))
    graph.replay()
    torch.cuda.synchronize()
    runs.append([t.clone() for t in out])
    assert all(torch.equal(a, b) for run in runs[1:] for a, b in zip(runs[0], run))


@pytest.mark.parametrize("H", [5, 56, 64, 65, 97, 256, 300])
@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_rnn_backward_kernel_matches_layer_ref(cuda_device, cell, H):
    """One launch against ``layer_bwd_ref``, the same contract in plain
    PyTorch, after a NaN fill, all three designs: dx, dR and the bias sums
    within BWD_RTOL of their largest magnitudes."""
    n_gates = 4 if cell == "lstm" else 3
    B, T, GH = 3, 30, n_gates * H
    gen = torch.Generator().manual_seed(H)
    x = torch.randn(B, T, GH, generator=gen).to(cuda_device)
    h = torch.randn(B, T, H, generator=gen).tanh().to(cuda_device)
    w_hh = (torch.rand(H, GH, generator=gen) * 2 - 1).to(cuda_device) * H ** -0.5
    bx, b_hh = (torch.randn(2, GH, generator=gen) * 0.1).to(cuda_device)
    r, dy = h @ w_hh, torch.randn(B, T, H, generator=gen).to(cuda_device)
    want = [torch.empty_like(x), torch.empty_like(x), x.new_empty(2, B, GH)]
    rnn_ops.layer_bwd_ref(n_gates, x, r, bx, b_hh, h, w_hh, dy, *want)
    got = [torch.empty_like(t) for t in want]
    _build.fill_shared_memory(float("nan"))
    rnn_ops._layer_bwd(n_gates, x, r, bx, b_hh, h, w_hh, dy, *got)
    torch.cuda.synchronize()
    _assert_grads_close(got, want, ("x", "R", "b"))


@pytest.mark.parametrize("head", [("lstm", False), ("gru", False), ("lstm", True), ("mamba", False),
                                  ("mamba", True)], ids=lambda h: f"{h[0]}-{'bi' if h[1] else 'uni'}")
def test_kernel_paths_give_every_parameter_the_plain_gradient(cuda_device, head):
    """The fault this slice repaired: a loss through a kernel's output had no
    gradient upstream of it on the card. Now every parameter the head trains
    gets the plain path's gradient (the declared-but-unread Mamba D none on
    either path)."""
    from vct_torch.models.recurrent import GRU, LSTM
    from vct_torch.models.ssm import ParallelMamba

    rnn_type, bidirectional = head
    cfg = ModelConfig(cnn_backbone="resnet18", rnn_type=rnn_type, rnn_input_size=8,
                      hidden_size=6, rnn_layer=3, bidirectional=bidirectional, dropout=0.0,
                      scan_impl="pallas")
    model = build_model(cfg, 4, seed=0).train()
    for p in model.cnn_backbone.parameters():
        p.requires_grad_(False)
    x = torch.rand(2, 4, 32, 32, 3, device=cuda_device, generator=_gen(cuda_device))
    grads = {}
    for impl in ("pallas", "scan"):
        for m in model.modules():
            if isinstance(m, (ParallelMamba, LSTM, GRU)):
                m.scan_impl = impl
        model.zero_grad(set_to_none=True)
        model(x).logsumexp(dim=-1).sum().backward()
        grads[impl] = {n: p.grad for n, p in model.named_parameters() if p.requires_grad}
    for name, want in grads["scan"].items():
        got = grads["pallas"][name]
        if name.endswith(".mixer.D"):
            assert got is None and want is None
            continue
        assert got is not None, name
        _assert_grads_close([got], [want], [name])


def test_finetune_train_step_updates_only_the_unfrozen_backbone(cuda_device):
    """With ``finetune`` and ``freeze_until``, a train step on the card runs
    the backbone's backward under bf16 autocast: the frozen prefixes keep
    their values and get no gradient, every other parameter moves, and the
    BatchNorm statistics stay as they were."""
    from vct_torch.core.config import Config
    from vct_torch.train.engine import Trainer

    cfg = Config().replace(**{
        "model.cnn_backbone": "resnet18", "model.rnn_type": "gru", "model.rnn_input_size": "8",
        "model.hidden_size": "6", "model.rnn_layer": "2", "model.scan_impl": "pallas",
        "model.compute_dtype": "bfloat16", "model.finetune": "true",
        "model.freeze_until": "conv1,bn1,layer1", "data.sequence_length": "4",
        "train.optimizer": "sgd", "train.learning_rate": "0.1"})
    trainer = Trainer(cfg, ["a", "b", "c", "d"])
    model = trainer.model
    before = {k: v.clone() for k, v in model.state_dict().items()}
    state = trainer.init_state()
    x = torch.rand(2, 4, 32, 32, 3, device=cuda_device, generator=_gen(cuda_device))
    loss, _, _ = trainer._train_step(state, x, torch.tensor([0, 3], device=cuda_device),
                                     torch.ones(2, device=cuda_device))
    assert torch.isfinite(loss)
    for name, p in model.named_parameters():
        frozen = name.startswith("cnn_backbone.") and name.split(".")[1].startswith(
            ("conv1", "bn1", "layer1"))
        assert (p.grad is None) == frozen, name
        assert torch.equal(p, before[name]) == frozen, name
    for name, buf in model.named_buffers():
        assert torch.equal(buf, before[name]), name


def _resume_overrides(tmp_path, rnn_type):
    return {"model.cnn_backbone": "resnet18", "model.rnn_type": rnn_type,
            "model.rnn_input_size": "8", "model.hidden_size": "6", "model.rnn_layer": "2",
            "model.scan_impl": "pallas", "model.dropout": "0.25", "data.sequence_length": "4",
            "data.img_height": "32", "data.img_width": "32", "train.batch_size": "4",
            "train.learning_rate": "1e-11", "train.lr_plateau_factor": "0.5",
            "train.lr_plateau_patience": "1", "train.model_path": str(tmp_path / "ck")}


@pytest.mark.parametrize("rnn_type", ["mamba", "lstm"])
def test_resume_on_the_card_is_bit_equal_to_the_uninterrupted_run(cuda_device, tmp_path,
                                                                   rnn_type):
    """Crashed after epochs 1 and 2 and resumed to 3 on the card (dropout,
    Adam, the plateau's lowered learning rate all in the saved state), a
    run's parameters and epoch and val losses equal an uninterrupted run's
    bit for bit, its resumed epochs launching the kernels as often."""
    from vct_torch.core.config import Config
    from vct_torch.data.synthetic import generate_dummy_data
    from vct_torch.train.engine import Trainer

    x, y, names = generate_dummy_data(12, 4, 32, 32, 4, seed=1)
    counters = (selective_scan, scan_ops.selective_scan_bwd, rnn_ops.lstm_stack,
                rnn_ops.lstm_stack_bwd)

    def fit(epochs, resume):
        cfg = Config().replace(**_resume_overrides(tmp_path, rnn_type),
                               **{"train.epochs": str(epochs), "train.resume": resume})
        trainer = Trainer(cfg, names)
        for fn in counters:
            fn.launches = 0
        state, run = trainer.fit(trainer.init_state(), x, y, val=(x[:4], y[:4]), log=False)
        torch.cuda.synchronize()
        return trainer.model.state_dict(), run, [fn.launches for fn in counters]

    whole, run_whole, launches_whole = fit(3, "false")
    fit(1, "true")
    fit(2, "true")
    resumed, run, launches_last = fit(3, "true")
    assert (run.epoch_losses, run.val_losses) == (run_whole.epoch_losses, run_whole.val_losses)
    for name, value in whole.items():
        assert torch.equal(resumed[name], value), name
    assert launches_last == [n // 3 for n in launches_whole] and any(launches_last)


def test_train_state_restores_across_devices(cuda_device, tmp_path):
    """A train state saved on the card restores into a trainer on the CPU
    and the other way round: weights, Adam's state and the step move to the
    trainer's device; a dropout generator of another device type keeps its
    seed, with a warning."""
    import contextlib
    import io

    from vct_torch.core.config import Config
    from vct_torch.train.checkpoint import load_train_state, save_train_state
    from vct_torch.train.engine import Trainer

    cfg = Config().replace(**_resume_overrides(tmp_path, "gru"))
    names = ["a", "b", "c", "d"]
    for src, dst in (("cuda", "cpu"), ("cpu", "cuda")):
        trainer = Trainer(cfg, names, device=src)
        state = trainer.init_state()
        x = torch.rand(2, 4, 32, 32, 3, device=src, generator=_gen(src))
        trainer._train_step(state, x, torch.tensor([0, 3], device=src), torch.ones(2, device=src))
        path = save_train_state(str(tmp_path / src), state, cfg, names, 1)
        other = Trainer(cfg.replace(**{"train.seed": "5"}), names, device=dst)
        fresh = other.init_state()
        gen = fresh.generator.get_state()
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            restored, epoch, _ = load_train_state(path, fresh)
        assert epoch == 1 and restored.step == 1 and "keeps its seed" in out.getvalue()
        assert torch.equal(restored.generator.get_state(), gen)
        for name, value in trainer.model.state_dict().items():
            got = other.model.state_dict()[name]
            assert got.device.type == dst and torch.equal(got.cpu(), value.cpu()), name
        for moments in restored.optimizer.state.values():
            assert moments["exp_avg"].device.type == dst


def test_load_model_serves_a_ported_reference_lrcn_on_the_card(cuda_device, tmp_path):
    """A seeded reference-layout state_dict through ``port_reference``
    (``--scan_impl pallas``) and ``load_model`` on the card serves through
    K1 and K3, its logits within 1e-4 of the same checkpoint on the CPU."""
    import chip_smoke
    from vct_torch.serve.deployment import load_model
    from vct_torch.tools.port_reference import main as port_main

    T = 4
    cfg = ModelConfig(num_classes=3, cnn_backbone="resnet18", rnn_input_size=8, hidden_size=6,
                      rnn_layer=2, scan_impl="pallas")
    sd = chip_smoke._seeded_state_dict(torch, chip_smoke._reference_lrcn_keys(cfg, T), seed=3)
    torch.save(sd, tmp_path / "ref.pth")
    assert port_main(["--state_dict", str(tmp_path / "ref.pth"), "--out", str(tmp_path / "m"),
                      "--num_classes", "3", "--sequence_length", str(T), "--cnn_backbone",
                      "resnet18", "--rnn_input_size", "8", "--hidden_size", "6", "--rnn_layer",
                      "2", "--scan_impl", "pallas", "--img_height", "16",
                      "--img_width", "16"]) == 0
    model, names, _ = load_model(str(tmp_path / "m"))
    model_cpu, _, _ = load_model(str(tmp_path / "m"), device="cpu")
    assert next(model.parameters()).is_cuda and names == ["class_0", "class_1", "class_2"]
    videos = [_clips((n, 16, 16, 3), seed=n) for n in (3, 7, 12)]
    pair_scores.launches = selective_scan.launches = 0
    clips = sample_decoded_clips(videos, "sad", T)
    probs = classify_videos(model, clips, batch_size=4)
    assert (pair_scores.launches, selective_scan.launches) == (2, cfg.rnn_layer)
    with torch.inference_mode():
        got = model(clips).cpu()
        want = model_cpu(sample_decoded_clips(videos, "sad", T, device="cpu"))
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    np.testing.assert_array_equal(probs.argmax(-1), want.argmax(-1).numpy())


def _op_cases(dev):
    """(operator, CUDA args, wrapper whose counter the launch adds to) for
    each registered kernel operator, at small shapes."""
    g = torch.Generator().manual_seed(5)

    def f32(*shape):
        return torch.randn(*shape, generator=g).to(dev)

    clips = torch.from_numpy(_clips((3, 13, 20, 24, 3), seed=5)).to(dev)
    B, L, D, N, H = 2, 9, 16, 32, 8
    ops = torch.ops.vct_torch
    return [
        (ops.pair_scores, (clips, "sad"), k1_ops.pair_scores),
        (ops.pair_scores, (clips, "flow"), k1_ops.pair_scores),
        (ops.ssim_pair_scores, (clips, 3, 255.0), ssim_ops.ssim_pair_scores),
        (ops.selective_scan, (f32(B, L, D), f32(B, L, D).abs(), -f32(D, N).abs(), f32(B, L, N),
                              f32(B, L, N), False), scan_ops.selective_scan),
        (ops.rnn_scan, (f32(B, L, 4 * H), f32(H, 4 * H), f32(4 * H), 4), rnn_ops.lstm_scan),
        (ops.rnn_scan, (f32(B, L, 3 * H), f32(H, 3 * H), f32(3 * H), 3), rnn_ops.gru_scan),
        (ops.rnn_stack, (f32(B, L, 4 * H), f32(2, H, 4 * H), f32(2, 4 * H), f32(1, H, 4 * H),
                         f32(1, 4 * H), 4), rnn_ops.lstm_stack),
        (ops.rnn_stack, (f32(B, L, 3 * H), f32(2, H, 3 * H), f32(2, 3 * H), f32(1, H, 3 * H),
                         f32(1, 3 * H), 3), rnn_ops.gru_stack),
    ]


@pytest.mark.parametrize("i", range(8), ids=["pair_scores_sad", "pair_scores_flow", "ssim",
                                             "selective_scan", "rnn_scan_lstm", "rnn_scan_gru",
                                             "rnn_stack_lstm", "rnn_stack_gru"])
def test_operator_cuda_implementation_is_the_counted_kernel(cuda_device, i):
    """Each operator's CUDA implementation, after NaN was left in shared
    memory, against its CPU implementation (the plain version) on the same
    inputs: bit-equal for K1 and K4, 1e-5 for the recurrences; one launch
    counted on its wrapper, none by the CPU call."""
    op, args, wrapper = _op_cases(cuda_device)[i]
    cpu_args = tuple(a.cpu() if isinstance(a, torch.Tensor) else a for a in args)
    wrapper.launches = 0
    want = op(*cpu_args)
    assert wrapper.launches == 0
    _build.fill_shared_memory(float("nan"))
    got = op(*args)
    torch.cuda.synchronize()
    assert wrapper.launches == 1
    if wrapper in (k1_ops.pair_scores, ssim_ops.ssim_pair_scores):
        assert torch.equal(got.cpu(), want)
    else:
        torch.testing.assert_close(got.cpu(), want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("rnn", ["mamba", "lstm", "bigru"])
def test_exported_model_on_the_card_launches_each_kernel(cuda_device, rnn, tmp_path):
    """A tiny LRCN exported on the card with SAD selection baked in: the
    program runs the kernels (their counters read around one call) and
    agrees with the eager path bit for bit."""
    from vct_torch.serve import aot

    heads = {"mamba": dict(rnn_type="mamba", rnn_layer=2),
             "lstm": dict(rnn_type="lstm", hidden_size=8, rnn_layer=2),
             "bigru": dict(rnn_type="gru", hidden_size=8, rnn_layer=2, bidirectional=True)}
    want = {"mamba": (scan_ops.selective_scan, 2), "lstm": (rnn_ops.lstm_stack, 1),
            "bigru": (rnn_ops.gru_scan, 4)}[rnn]
    model = build_model(ModelConfig(num_classes=3, cnn_backbone="resnet18", rnn_input_size=8,
                                    scan_impl="pallas", **heads[rnn]), 4)
    path = str(tmp_path / "m.vctaot")
    aot.export_servable(model, ["a", "b", "c"], (4, 32, 32, 3), path, batch_sizes=(2,),
                        device_sampling="sad", raw_len=8)
    sv = aot.AotServable.load(path)
    raw = _clips((2, 8, 32, 32, 3), seed=6)
    lens = np.array([8, 6], np.int32)
    for fn in (k1_ops.pair_scores, want[0]):
        fn.launches = 0
    got = sv.classify_raw(raw, lens)
    assert (k1_ops.pair_scores.launches, want[0].launches) == (1, want[1])
    with torch.inference_mode():
        x = preprocess.device_sample_clips(torch.from_numpy(raw).to(cuda_device), 4,
                                           method="sad",
                                           lengths=torch.from_numpy(lens).to(cuda_device))
        ref = torch.softmax(model(x).float(), dim=-1).cpu().numpy()
    np.testing.assert_array_equal(got, ref)


def test_sweep_trials_train_through_the_kernels_with_flat_memory(cuda_device, tmp_path):
    """A two-trial grid (Mamba, LSTM; scan_impl "pallas", the feature cache
    on) through ``vct_torch.sweep``: each trial launches its head's forward
    and backward kernels as often as its steps say, and the memory a trial
    leaves allocated does not grow from the first trial to the second."""
    from vct_torch.core.config import Config
    from vct_torch.data.batcher import train_test_split
    from vct_torch.data.synthetic import generate_dummy_data
    from vct_torch.sweep import SweepRunner, SweepStore, grid_search

    x, y, names = generate_dummy_data(12, 4, 32, 32, 4, seed=1)
    cfg = Config().replace(**{
        "model.cnn_backbone": "resnet18", "model.rnn_input_size": "8", "model.hidden_size": "8",
        "model.rnn_layer": "2", "model.scan_impl": "pallas", "data.sequence_length": "4",
        "data.img_height": "32", "data.img_width": "32", "train.batch_size": "4",
        "train.epochs": "2", "train.feature_cache": "true", "train.save_model": "false",
        "sweep.checkpoint_file": str(tmp_path / "ckpt.json"), "sweep.f1_threshold": "-1",
        "sweep.test_runs": "1"})
    kernels = {"mamba": (selective_scan, scan_ops.selective_scan_bwd),
               "lstm": (rnn_ops.lstm_stack, rnn_ops.lstm_stack_bwd)}
    launches, memory, failed = {}, [], []

    class Counted(SweepRunner):
        def _train_once(self, cfg):
            fns = kernels[cfg.model.rnn_type]
            for fn in fns:
                fn.launches = 0
            try:
                metrics = super()._train_once(cfg)
            except Exception as e:  # the runner would log it and go on
                failed.append(e)
                raise
            torch.cuda.synchronize()
            launches[cfg.model.rnn_type] = [fn.launches for fn in fns]
            memory.append(torch.cuda.memory_allocated())
            return metrics

    runner = Counted(cfg, store=SweepStore(cfg.sweep.checkpoint_file), data=(x, y, names))
    grid_search(runner, {"model.rnn_type": ["mamba", "lstm"]})
    assert not failed and len(runner.store.load()) == 2
    x_tr, x_te, _, _ = train_test_split(x, y, cfg.data.val_fraction, cfg.data.split_seed)
    steps = 2 * -(-len(x_tr) // 4)
    forwards = steps + -(-len(x_te) // 4)
    # Mamba: a K3 forward and backward a block; LSTM: one K2 forward a pass,
    # one K2 backward a layer.
    assert launches == {"mamba": [2 * forwards, 2 * steps], "lstm": [forwards, 2 * steps]}
    assert memory[1] <= memory[0] + (16 << 20), memory


@pytest.mark.parametrize("name", ["resnet50", "vgg16"])
def test_fold_takes_raw_uint8_as_x_over_255_on_the_card(cuda_device, name):
    """f32 with TF32 off: raw uint8 clips into a backbone whose stem conv
    holds the 1/255 (``fold_input_scale_into_stem``) within 1e-4 of x / 255
    into the plain one; vgg16's stem has a bias, which the fold leaves."""
    from vct_torch.models import init_weights
    from vct_torch.models.backbones import build_backbone
    from vct_torch.models.backbones.port import fold_input_scale_into_stem
    from vct_torch.models.lrcn import backbone_features

    backbone, _ = build_backbone(name)
    backbone = init_weights(backbone, seed=0).to(cuda_device).eval()
    folded = fold_input_scale_into_stem(backbone, name)
    raw = torch.from_numpy(_clips((2, 4, 64, 64, 3))).to(cuda_device)
    with torch.no_grad():
        want = backbone_features(backbone, raw.float() / 255.0, torch.float32)
        got = backbone_features(folded, raw, torch.float32)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


def test_remat_backbone_gives_the_same_gradients_on_the_card(cuda_device):
    """A resnet18 ``finetune`` step with a Mamba head on K3 (forward and
    backward), under cudnn's deterministic algorithms: ``remat_backbone``
    on and off give bit-equal logits and gradients, and the backbone's
    forward runs twice a step with it (the recompute) and once without."""
    from vct_torch.core.config import Config
    from vct_torch.train.engine import Trainer

    cfg = Config().replace(**{
        "model.cnn_backbone": "resnet18", "model.rnn_type": "mamba", "model.rnn_input_size": "8",
        "model.hidden_size": "6", "model.rnn_layer": "2", "model.scan_impl": "pallas",
        "model.dropout": "0.0", "model.finetune": "true", "data.sequence_length": "4"})
    trainer = Trainer(cfg, ["a", "b", "c", "d"])
    trainer.init_state()
    model = trainer.model.train()
    calls = []
    model.cnn_backbone.register_forward_pre_hook(lambda *_: calls.append(1))
    x = torch.rand(2, 4, 32, 32, 3, device=cuda_device, generator=_gen(cuda_device))
    y, mask = torch.tensor([0, 3], device=cuda_device), torch.ones(2, device=cuda_device)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    runs = {}
    try:
        for remat in (True, False):
            model.remat_backbone = remat
            model.zero_grad(set_to_none=True)
            calls.clear()
            before = scan_ops.selective_scan_bwd.launches
            logits = model(x)
            trainer._loss_fn(logits, y, mask)[0].backward()
            torch.cuda.synchronize()
            assert scan_ops.selective_scan_bwd.launches == before + 2
            runs[remat] = (len(calls), logits.detach(),
                           {n: p.grad for n, p in model.named_parameters() if p.grad is not None})
    finally:
        torch.backends.cudnn.deterministic = deterministic
    assert (runs[True][0], runs[False][0]) == (2, 1)
    assert torch.equal(runs[True][1], runs[False][1])
    assert runs[True][2].keys() == runs[False][2].keys()
    assert any(n.startswith("cnn_backbone.") for n in runs[True][2])
    for name, g in runs[True][2].items():
        assert torch.equal(g, runs[False][2][name]), name
