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
from vct_torch.ops.ssim import ssim_pair_scores, ssim_pair_scores_ref

T = 6
IMAGENET = (np.array([0.485, 0.456, 0.406], np.float32), np.array([0.229, 0.224, 0.225], np.float32))

# test_pallas_ops.py's SSIM shapes: non-tile-aligned W*C, C=1, a small clip.
SSIM_SHAPES = [(2, 11, 16, 43, 3), (1, 5, 9, 11, 3), (3, 4, 8, 128, 1), (2, 6, 8, 8, 3)]
# L=2, the kernel-audit geometries (odd H, C=1 with L crossing vct's chunk),
# the smallest frame.
MORE_SHAPES = [(2, 2, 5, 7, 3), (1, 9, 11, 44, 3), (2, 21, 16, 48, 1), (2, 4, 3, 3, 3)]


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


@pytest.mark.parametrize("shape", SSIM_SHAPES + MORE_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_ssim_pair_scores_matches_vct(shape):
    x = _clips(shape)
    got = ssim_pair_scores(torch.from_numpy(x)).numpy()
    assert got.shape == (shape[0], shape[1] - 1) and got.dtype == np.float32
    for want in (np.asarray(vct_ssim_pair_scores(jnp.asarray(x))), _vct_device_ssim(x)):
        np.testing.assert_allclose(got, want, atol=2e-6, rtol=0)
        _same_ranking(got, want)


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
