"""vct_torch frame selection against vct's, on the CPU.

The same uint8 (or float) clips go through ``vct.data.preprocess
.device_sample_clips`` (its Pallas scorer in interpret mode) and the port's
``device_sample_clips``; the selected, normalized frames must agree to
rtol 1e-6. That is one f32 ulp: XLA turns the division by 255 into a
multiplication by its reciprocal, the port divides. Frames one uint8 step
apart differ by 1/255, so the tolerance still demands the same selection.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vct.data import samplers as vct_samplers
from vct.data import video as vct_video
from vct.data.preprocess import device_sample_clips as vct_sample
from vct.serve import deployment as vct_deployment
from vct_torch.data import samplers
from vct_torch.data.preprocess import device_sample_clips, sample_indices
from vct_torch.serve.deployment import sample_decoded_clips

T = 6


def _raw(B=3, L=20, H=8, W=8, C=3, seed=0):
    return np.random.RandomState(seed).randint(0, 256, size=(B, L, H, W, C), dtype=np.uint8)


def _both(raw, lengths=None, **kw):
    want = vct_sample(
        jnp.asarray(raw), T,
        lengths=None if lengths is None else jnp.asarray(lengths, jnp.int32), **kw,
    )
    got = device_sample_clips(
        torch.from_numpy(raw), T,
        lengths=None if lengths is None else torch.tensor(lengths), **kw,
    )
    return got.numpy(), np.asarray(want)


def _same(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("ragged", [False, True], ids=["full", "ragged"])
@pytest.mark.parametrize("method", ["sad", "flow", "uniform"])
def test_device_sample_clips_matches_vct(method, ragged):
    raw = _raw()
    lengths = [20, 13, 9] if ragged else None
    got, want = _both(raw, lengths, method=method)
    assert got.shape == (3, T, 8, 8, 3) and got.dtype == np.float32
    _same(got, want)


@pytest.mark.parametrize("short_pad", ["cycle", "last"])
def test_short_clips_pad_like_vct(short_pad):
    raw = _raw(B=4)
    got, want = _both(raw, [20, 6, 4, 1], method="sad", short_pad=short_pad)
    _same(got, want)


@pytest.mark.parametrize("short_pad", ["cycle", "last"])
def test_clip_not_longer_than_T(short_pad):
    raw = _raw(B=2, L=T)
    got, want = _both(raw, [T, 3], method="sad", short_pad=short_pad)
    _same(got, want)


def test_static_clip_ties_select_lower_indices():
    # Runs of identical frames: many transitions tie at 0 and at equal SADs.
    base = _raw(B=1, L=4)
    raw = np.repeat(base, 5, axis=1)  # (1, 20, ...), 3 nonzero transitions
    idx = sample_indices(torch.from_numpy(raw), T, "sad").numpy()
    got, want = _both(raw, method="sad")
    _same(got, want)
    np.testing.assert_array_equal(idx[0], [0, 1, 2, 4, 9, 14])


@pytest.mark.parametrize("method", ["sad", "flow"])
def test_float_frames_take_the_plain_scorer(method):
    raw = _raw().astype(np.float32)
    got, want = _both(raw, [20, 13, 9], method=method)
    _same(got, want)


def test_device_frame_scores_matches_vct():
    clip = _raw(B=1)[0].astype(np.float32)
    for method in ("sad", "flow"):
        want = np.asarray(vct_samplers.device_frame_scores(jnp.asarray(clip), method))
        got = samplers.device_frame_scores(torch.from_numpy(clip), method).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6)


def test_canonical_topk_matches_vct():
    scores = np.random.RandomState(3).randn(19).astype(np.float32)
    scores[[2, 5, 11]] = 1.5  # ties
    want = np.asarray(vct_samplers.device_topk_indices(jnp.asarray(scores), T, "canonical"))
    got = samplers.device_topk_indices(torch.from_numpy(scores), T, "canonical").numpy()
    np.testing.assert_array_equal(got, want)
    clip = _raw(B=1)[0]
    np.testing.assert_array_equal(
        samplers.device_select_topk(torch.from_numpy(clip), torch.from_numpy(scores), T).numpy(),
        np.asarray(vct_samplers.device_select_topk(jnp.asarray(clip), jnp.asarray(scores), T)),
    )


def test_duplicate_frames_matches_vct():
    frames = list(_raw(B=1, L=4)[0])
    for n in (2, 4, 9):
        want = vct_samplers.duplicate_frames(frames, n)
        got = samplers.duplicate_frames(frames, n)
        np.testing.assert_array_equal(np.stack(got), np.stack(want))


def _videos(lengths, seed=1):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, size=(n, 8, 8, 3), dtype=np.uint8) for n in lengths]


@pytest.mark.parametrize("sampling", ["sad", "optical_flow", "uniform", "ssim", "ssim_most_unique"])
def test_sample_decoded_clips_matches_vct(sampling, tmp_path, monkeypatch):
    lengths = [3, 6, 7, 12, 13, 30]  # short, equal to T, the 12 and 24 buckets, 48
    videos = _videos(lengths)
    names = [f"v{i}.mp4" for i in range(len(videos))]
    for name in names:
        (tmp_path / name).write_bytes(b"")
    by_name = dict(zip(names, videos))
    monkeypatch.setattr(
        vct_video, "decode_video", lambda path, h, w: list(by_name[os.path.basename(path)])
    )
    want, got_names = vct_deployment._load_with_device_sampling(str(tmp_path), sampling, T, 8, 8)
    assert got_names == names
    got = sample_decoded_clips(videos, sampling, T, device="cpu")
    assert got.dtype == torch.float32
    _same(got.numpy(), want)


def test_sample_decoded_clips_rejects_unknown_method():
    with pytest.raises(KeyError):
        sample_decoded_clips(_videos([8]), "sift", T, device="cpu")
