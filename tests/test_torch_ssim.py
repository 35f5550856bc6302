"""vct_torch SSIM scoring (K4), frame normalize (K6) and resize against vct.

On the CPU the port's wrappers run their plain PyTorch versions; vct runs
its Pallas kernels in interpret mode, as tests/test_pallas_ops.py does, and
its XLA ``_device_ssim`` with f32 convolutions. tests/test_torch_cuda.py
holds the CUDA kernels against their plain versions on the card.

Tolerances:
* SSIM scores atol 2e-6 (test_pallas_ops.py's tolerance) and equal
  rankings: the window sums are exact on every side, so only the order of
  the f32 operations and of the mean's sum differ;
* selected, normalized frames rtol 1e-6: one f32 ulp, XLA multiplies by
  1/255 where the port divides (ROADMAP Queue 3); the frames still have to
  be the same ones;
* the bilinear resize atol 1e-6 on values in [0, 1];
* K6 bit-exact for the identity, and atol 1e-6 with a mean and std: XLA
  on the CPU fuses ``x * (1/255) - mean`` into one FMA, so about half of
  vct's values are 1-2 ulp (up to 4.8e-7) from the port's, which rounds
  the product first as the TPU kernel's two operations do.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vct.data import samplers as vct_samplers
from vct.data.preprocess import device_sample_clips as vct_sample
from vct.data.preprocess import preprocess_clips as vct_preprocess
from vct.ops.preprocess_pallas import normalize_frames_pallas
from vct.ops.ssim_pallas import ssim_pair_scores as vct_ssim_pair_scores
from vct_torch.data import samplers
from vct_torch.data.preprocess import device_sample_clips, preprocess_clips, sample_indices
from vct_torch.ops.preprocess import normalize_frames, normalize_frames_ref
from vct_torch.ops import ssim as ssim_ops
from vct_torch.ops.ssim import ssim_pair_scores, ssim_pair_scores_ref

T = 6
IMAGENET = (np.array([0.485, 0.456, 0.406], np.float32), np.array([0.229, 0.224, 0.225], np.float32))

# test_pallas_ops.py's SSIM shapes: non-tile-aligned W*C, C=1, a small clip.
SSIM_SHAPES = [(2, 11, 16, 43, 3), (1, 5, 9, 11, 3), (3, 4, 8, 128, 1), (2, 6, 8, 8, 3)]
# L=2, the kernel-audit geometries (odd H, C=1 with L crossing vct's chunk),
# the smallest frame.
MORE_SHAPES = [(2, 2, 5, 7, 3), (1, 9, 11, 44, 3), (2, 21, 16, 48, 1), (2, 4, 3, 3, 3)]
# The kernel's edges: one output row (H=3), and odd row lengths W*C = 21, 5
# and 129 (its byte path).
EDGE_SHAPES = [(2, 5, 3, 7, 3), (3, 6, 7, 5, 1), (1, 4, 5, 43, 3)]


def _clips(shape, seed=0):
    return np.random.RandomState(seed).randint(0, 256, size=shape, dtype=np.uint8)


def _vct_device_ssim(clips):
    with jax.default_matmul_precision("float32"):
        return np.stack([
            np.asarray(vct_samplers._device_ssim(
                jnp.asarray(c[:-1], jnp.float32), jnp.asarray(c[1:], jnp.float32)))
            for c in clips
        ])


def _same_ranking(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.argsort(g, kind="stable"), np.argsort(w, kind="stable"))


@pytest.mark.parametrize("shape", SSIM_SHAPES + MORE_SHAPES + EDGE_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_ssim_pair_scores_matches_vct(shape):
    x = _clips(shape)
    got = ssim_pair_scores(torch.from_numpy(x)).numpy()
    assert got.shape == (shape[0], shape[1] - 1) and got.dtype == np.float32
    for want in (np.asarray(vct_ssim_pair_scores(jnp.asarray(x))), _vct_device_ssim(x)):
        np.testing.assert_allclose(got, want, atol=2e-6, rtol=0)
        _same_ranking(got, want)


# (B, L, H, W, C) the CUDA kernel's plan is held to: the bench step and the
# two served buckets (the main path), chip_smoke's K4 shapes, one output row
# (H=3), L=2, L-1 prime (13, 23) and H-2 prime (17, 13).
PLAN_SHAPES = [
    (32, 120, 80, 80, 3), (1, 120, 80, 80, 3), (1, 240, 80, 80, 3),
    (4, 2, 80, 80, 3), (2, 12, 16, 16, 3), (1, 9, 11, 44, 3), (2, 10, 8, 48, 3), (1, 7, 9, 86, 3),
    (2, 21, 16, 48, 1), (3, 5, 3, 3, 3), (3, 13, 7, 5, 1), (2, 10, 8, 8, 3), (2, 9, 12, 132, 1),
    (2, 9, 12, 258, 1), (2, 9, 12, 5, 1), (1, 30, 3, 80, 3), (1, 2, 80, 80, 3), (1, 14, 80, 80, 3),
    (2, 24, 19, 40, 3), (1, 24, 15, 80, 3), (4, 30, 80, 80, 3), (1, 6, 9, 128, 3),
    (1, 9, 14, 320, 3), (1, 4, 6, 3840, 3), (1, 4, 6, 426, 3), (1, 120, 240, 320, 3),
    (1, 120, 1080, 1920, 3), (1, 120, 2160, 3840, 3),
]
MAIN_PATH_SHAPES = PLAN_SHAPES[:3]


def _spans(p, L, H):
    """The plan's chunks as (first transition, transitions) and bands as
    (first output row, output rows), cut as ssim.cu cuts them."""
    K, R = p["chunk_pairs"], p["band_rows"]
    chunks = [(t0, min(K, L - 1 - t0)) for t0 in range(0, L - 1, K)]
    bands = [(i0, min(R, H - 2 - i0)) for i0 in range(0, H - 2, R)]
    return chunks, bands


@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_ssim_plan_cuts_every_shape_exactly(shape):
    """Chunks cover the transitions 0..L-2 once, bands the output rows
    0..H-3 once, each band reading its rows and two more inside the frame;
    the shared memory fits a block; the card gets about two blocks an SM
    (``MIN_BLOCKS``), or a block for every (pair, row) where there are
    fewer."""
    B, L, H, W, C = shape
    p = ssim_ops.plan(*shape)
    chunks, bands = _spans(p, L, H)
    assert [t for t0, n in chunks for t in range(t0, t0 + n)] == list(range(L - 1))
    assert [i for i0, n in bands for i in range(i0, i0 + n)] == list(range(H - 2))
    assert all(1 <= n <= p["chunk_pairs"] <= ssim_ops.MAX_CHUNK_PAIRS for _, n in chunks)
    assert all(1 <= n <= p["band_rows"] and i0 + n + 2 <= H for i0, n in bands)
    assert (len(chunks), len(bands)) == (p["chunks"], p["bands"])
    assert p["blocks"] == B * p["chunks"] * p["bands"]
    assert p["smem_bytes"] + 1024 <= 227 * 1024
    assert p["threads"] % 32 == 0 and 32 <= p["threads"] <= 256
    assert p["blocks"] >= min(ssim_ops.MIN_BLOCKS, B * (L - 1) * (H - 2))


@pytest.mark.parametrize("shape", MAIN_PATH_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_ssim_plan_fills_the_card_on_the_main_path(shape):
    """The bench step keeps whole frames as bands; a single served video is
    cut into bands and short chunks, so that it too gives the card about
    two blocks an SM: at least nine tenths of 2 x 132, in one wave."""
    B, L, H, W, C = shape
    p = ssim_ops.plan(*shape)
    assert p["blocks"] >= ssim_ops.MIN_BLOCKS == 9 * 2 * 132 // 10
    if B == 1:
        assert p["blocks"] <= ssim_ops.RESIDENT_BLOCKS
    if B == 32:
        assert p["bands"] == 1
    else:
        assert p["bands"] > 1 and p["chunk_pairs"] < ssim_ops.MAX_CHUNK_PAIRS


@pytest.mark.parametrize("W", [320, 1920, 3840, 11520])
def test_ssim_plan_shared_memory_does_not_grow_with_width(W):
    """A block stages only the bytes its column group reads, so decoded
    frames of any width, 4K included, get a plan with every K, in the
    shared memory of a frame 86 pixels wide."""
    p = ssim_ops.plan(1, 120, 64, W, 3, ssim_ops.MAX_CHUNK_PAIRS, 8)
    narrow = ssim_ops.plan(1, 120, 64, 86, 3, ssim_ops.MAX_CHUNK_PAIRS, 8)
    assert p["smem_bytes"] == narrow["smem_bytes"]
    assert p["threads"] == 256 and p["smem_bytes"] + 1024 <= 227 * 1024


@pytest.mark.parametrize("K,R", [(1, 1), (3, 5), (7, 17), (2, 40)])
def test_ssim_plan_takes_a_forced_chunk_and_band(K, R):
    p = ssim_ops.plan(2, 24, 19, 40, 3, K, R)
    chunks, bands = _spans(p, 24, 19)
    assert (p["chunk_pairs"], p["band_rows"]) == (K, min(R, 17))
    assert (len(chunks), len(bands)) == (-(-23 // K), -(-17 // min(R, 17)))


@pytest.mark.parametrize("K", [8, 24])
def test_ssim_plan_refuses_chunks_the_kernel_has_no_instance_for(K):
    with pytest.raises(ValueError, match="no plan"):
        ssim_ops.plan(2, 30, 19, 40, 3, K, 0)


@pytest.mark.parametrize("shape", [(3, 8, 7, 3), (2, 16, 43, 3), (4, 5, 9, 1)])
def test_device_ssim_matches_vct(shape):
    rng = np.random.RandomState(1)
    a = rng.randint(0, 256, size=shape).astype(np.float32)
    b = np.clip(a + rng.randint(-40, 41, size=shape), 0, 255).astype(np.float32)
    with jax.default_matmul_precision("float32"):
        want = np.asarray(vct_samplers._device_ssim(jnp.asarray(a), jnp.asarray(b)))
    got = samplers._device_ssim(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert got.shape == (shape[0],)
    np.testing.assert_allclose(got, want, atol=2e-6, rtol=0)


def test_device_frame_scores_ssim_matches_vct():
    clip = _clips((9, 8, 10, 3)).astype(np.float32)
    with jax.default_matmul_precision("float32"):
        want = np.asarray(vct_samplers.device_frame_scores(jnp.asarray(clip), "ssim"))
    got = samplers.device_frame_scores(torch.from_numpy(clip), "ssim").numpy()
    np.testing.assert_allclose(got, want, atol=2e-6, rtol=0)


def test_static_clip_scores_exactly_one():
    """Equal frames make the numerator and denominator the same f32 value in
    the port. vct in interpret mode lands an ulp below 1 (XLA on the CPU
    fuses some of its products into FMAs), within the tolerance."""
    x = np.repeat(_clips((2, 1, 9, 11, 3)), 5, axis=1)
    want = np.asarray(vct_ssim_pair_scores(jnp.asarray(x)))
    got = ssim_pair_scores(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.ones((2, 4), np.float32))
    np.testing.assert_allclose(want, got, atol=2e-6, rtol=0)


def test_ssim_pair_scores_refuses_what_vct_refuses():
    floats = torch.zeros((1, 3, 4, 4, 3))
    with pytest.raises(TypeError, match="integer"):
        vct_ssim_pair_scores(jnp.zeros((1, 3, 4, 4, 3)))
    with pytest.raises(TypeError, match="integer"):
        ssim_pair_scores(floats)
    tiny = _clips((1, 3, 2, 2, 3))
    with pytest.raises(ValueError, match="window"):
        vct_ssim_pair_scores(jnp.asarray(tiny))
    with pytest.raises(ValueError, match="window"):
        ssim_pair_scores(torch.from_numpy(tiny))
    with pytest.raises(ValueError, match="window"):
        ssim_pair_scores(torch.from_numpy(_clips((1, 3, 8, 2, 3))))


@pytest.mark.parametrize("L", [0, 1])
def test_ssim_pair_scores_short_clip(L):
    x = _clips((3, L, 2, 2, 3))  # frames below the window: L < 2 returns first
    want = np.asarray(vct_ssim_pair_scores(jnp.asarray(x)))
    assert ssim_pair_scores(torch.from_numpy(x)).shape == want.shape == (3, 0)


def test_ssim_plain_version_takes_wider_integers():
    x = _clips((2, 5, 7, 9, 3))
    want = ssim_pair_scores_ref(torch.from_numpy(x))
    for dtype in (torch.int16, torch.int32, torch.int64):
        assert torch.equal(ssim_pair_scores_ref(torch.from_numpy(x).to(dtype)), want)


def _both(raw, lengths=None, **kw):
    with jax.default_matmul_precision("float32"):
        want = vct_sample(
            jnp.asarray(raw), T,
            lengths=None if lengths is None else jnp.asarray(lengths, jnp.int32), **kw,
        )
    got = device_sample_clips(
        torch.from_numpy(raw), T,
        lengths=None if lengths is None else torch.tensor(lengths), **kw,
    )
    return got.numpy(), np.asarray(want)


def _ssim_raw(B=3, L=20, seed=0):
    """Clips of drifting scenes with cuts, so the SSIM scores spread out."""
    rng = np.random.RandomState(seed)
    out = np.empty((B, L, 8, 10, 3), np.uint8)
    for b in range(B):
        frame = rng.randint(0, 256, (8, 10, 3))
        for t in range(L):
            if rng.rand() < 0.2:
                frame = rng.randint(0, 256, (8, 10, 3))
            frame = np.clip(frame + rng.randint(-20, 21, frame.shape), 0, 255)
            out[b, t] = frame
    return out


@pytest.mark.parametrize("floats", [False, True], ids=["uint8", "float"])
@pytest.mark.parametrize("lengths", [None, [20, 13, 9], [20, 6, 1]], ids=["full", "ragged", "short"])
def test_ssim_selection_matches_vct(lengths, floats):
    raw = _ssim_raw()
    if floats:
        raw = raw.astype(np.float32)
    got, want = _both(raw, lengths, method="ssim")
    assert got.shape == (3, T, 8, 10, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_ssim_static_ties_break_by_lower_index():
    """Static runs tie exactly in the port, and the stable sort keeps the
    lower transitions. vct's jitted selection on the CPU fuses ``1 - mean``
    into an FMA, so its static transitions score a few 1e-9 apart, within
    the score tolerance, and that noise may pick other frames of equal
    content (ROADMAP Queue 3)."""
    raw = np.repeat(_clips((1, 4, 8, 8, 3)), 5, axis=1)  # 3 scene cuts, then ties at 0
    scores = 1.0 - ssim_pair_scores(torch.from_numpy(raw)).numpy()
    static = np.ones(19, bool)
    static[[4, 9, 14]] = False
    np.testing.assert_array_equal(scores[0, static], 0.0)
    want = np.asarray(jax.jit(lambda r: 1.0 - vct_ssim_pair_scores(r))(jnp.asarray(raw)))
    np.testing.assert_allclose(scores, want, atol=2e-6, rtol=0)
    idx = sample_indices(torch.from_numpy(raw), T, "ssim").numpy()
    # frame 0, the three frames after the cuts, then the lowest tied transitions' later frames
    np.testing.assert_array_equal(idx[0], [0, 1, 2, 5, 10, 15])


@pytest.mark.parametrize("out_hw", [(16, 20), (4, 5), (6, 12)], ids=["up", "down", "nonsquare"])
def test_resize_matches_vct(out_hw):
    raw = _clips((2, 3, 8, 10, 3))
    want = np.asarray(vct_preprocess(jnp.asarray(raw), out_hw=out_hw))
    got = preprocess_clips(torch.from_numpy(raw), out_hw=out_hw).numpy()
    assert got.shape == (2, 3) + out_hw + (3,)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("method", ["sad", "ssim"])
def test_sample_clips_with_resize_matches_vct(method):
    raw = _ssim_raw()
    got, want = _both(raw, [20, 13, 9], method=method, out_hw=(12, 7))
    assert got.shape == (3, T, 12, 7, 3)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_resize_to_the_frame_size_is_the_identity():
    raw = torch.from_numpy(_clips((2, 3, 8, 10, 3)))
    assert torch.equal(preprocess_clips(raw, out_hw=(8, 10)), preprocess_clips(raw))


@pytest.mark.parametrize("shape", [(2, 3, 8, 8, 3), (3, 7, 5, 3), (2, 5, 9, 1)])
@pytest.mark.parametrize("stats", ["identity", "imagenet"])
def test_normalize_frames_matches_vct(shape, stats):
    raw = _clips(shape)
    C = shape[-1]
    mean, std = (None, None) if stats == "identity" else (IMAGENET[0][:C], IMAGENET[1][:C])
    want = np.asarray(normalize_frames_pallas(jnp.asarray(raw), mean, std))
    got = normalize_frames(torch.from_numpy(raw), mean, std).numpy()
    assert got.shape == shape and got.dtype == np.float32
    if mean is None:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(got, normalize_frames_ref(torch.from_numpy(raw), mean, std).numpy())


def test_normalize_frames_refuses_bad_input():
    raw = torch.from_numpy(_clips((2, 4, 4, 3)))
    with pytest.raises(TypeError):
        normalize_frames(raw.float())
    with pytest.raises(ValueError):
        normalize_frames(raw[0, 0])
    with pytest.raises(ValueError, match="per-channel"):
        normalize_frames(raw, mean=[0.5, 0.5])
