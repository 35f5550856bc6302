"""vct_torch serving entry points against vct.serve.deployment, on the CPU.

Probabilities are compared at atol 1e-5 (softmax of logits that agree to
1e-4 at these small magnitudes); the slice end to end (raw uint8 -> SAD
selection -> LRCN logits -> softmax) at atol = rtol = 1e-4.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vct.core.config import ModelConfig as VctModelConfig
from vct.data.preprocess import device_sample_clips as vct_sample
from vct.models import build_model as vct_build_model
from vct.serve import deployment as vct_deployment
from vct_torch.bridge import load_vct_variables
from vct_torch.core.config import ModelConfig
from vct_torch.data.preprocess import device_sample_clips
from vct_torch.models import build_model
from vct_torch.serve import deployment

T = 4
CFG = dict(num_classes=3, cnn_backbone="resnet18", rnn_type="mamba",
           rnn_input_size=8, rnn_layer=3, scan_impl="pallas")


@pytest.fixture(scope="module")
def models():
    flax_model = vct_build_model(VctModelConfig(**CFG), T)
    x0 = jnp.zeros((1, T, 16, 16, 3), jnp.float32)
    variables = jax.tree_util.tree_map(np.asarray, flax_model.init(jax.random.PRNGKey(0), x0))
    torch_model = build_model(ModelConfig(**CFG), T, device="cpu")
    load_vct_variables(torch_model, variables)
    return flax_model, variables, torch_model


def _clips(n, seed=0):
    return np.random.RandomState(seed).rand(n, T, 16, 16, 3).astype(np.float32)


@pytest.mark.parametrize("batch_size", [2, 3])
def test_classify_videos_matches_vct(models, batch_size):
    flax_model, variables, torch_model = models
    clips = _clips(5)  # the last chunk is partial and zero-padded
    want = vct_deployment.classify_videos(flax_model, variables, clips, batch_size=batch_size)
    got = deployment.classify_videos(torch_model, clips, batch_size=batch_size, device="cpu")
    assert got.shape == (5, 3)
    np.testing.assert_allclose(got.sum(-1), 1.0, rtol=1e-6)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_classify_and_display_contract(models, capsys):
    _, _, torch_model = models
    names = ["@a_video_1.mp4", "@b_video_2.mp4", "c.mp4"]
    class_names = ["x", "y", "z"]
    probs = deployment.classify_videos(torch_model, _clips(3), batch_size=2, device="cpu")
    results = deployment.classify_and_display(
        torch_model, _clips(3), names, class_names, batch_size=2, device="cpu"
    )
    out = capsys.readouterr().out
    assert [r["video_name"] for r in results] == names
    for r, p in zip(results, probs):
        assert sorted(r["labels"]) == class_names
        assert r["labels"][0] == class_names[int(np.argmax(p))]
        assert r["scores"] == sorted(r["scores"], reverse=True)
        np.testing.assert_allclose(r["scores"], np.sort(p)[::-1], rtol=1e-6)
        assert f"Processed {r['video_name']}: {r['labels'][0]}" in out
    start = out.index("[")
    printed = json.loads(out[start:out.index("\nLabel Counts:")])
    assert printed == results
    counts = out.split("Label Counts:\n", 1)[1].strip().splitlines()
    assert sum(int(line.split(": ")[1]) for line in counts) == 3


def test_classify_and_display_with_given_probs(capsys):
    probs = np.array([[0.2, 0.8]], np.float32)
    want = vct_deployment.classify_and_display(None, None, None, ["v"], ["a", "b"], probs=probs)
    got = deployment.classify_and_display(None, None, ["v"], ["a", "b"], probs=probs)
    for w, g in zip(want, got):
        assert {k: w[k] for k in ("video_name", "labels", "scores")} == {
            k: g[k] for k in ("video_name", "labels", "scores")
        }


@pytest.mark.parametrize("name", [
    "@user_video_123.mp4", "@a.b_video_9", "plain.mp4", "@x_video_.mp4",
])
def test_construct_url_matches_vct(name):
    assert deployment.construct_url(name) == vct_deployment.construct_url(name)


@pytest.mark.parametrize("n", [1, 60, 120, 121, 240, 241, 1000])
def test_length_bucket_matches_vct(n):
    assert deployment._length_bucket(n, 60) == vct_deployment._length_bucket(n, 60)


def test_device_methods_match_vct():
    assert deployment._DEVICE_METHODS == vct_deployment._DEVICE_METHODS


@pytest.mark.parametrize("entry", ["sample", "classify", "build"])
def test_entry_points_refuse_cpu_fallback(entry, monkeypatch, models):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        if entry == "sample":
            deployment.sample_decoded_clips([np.zeros((5, 8, 8, 3), np.uint8)], "sad", T)
        elif entry == "classify":
            deployment.classify_videos(models[2], _clips(1))
        else:
            build_model(ModelConfig(**CFG), T)


def test_slice_end_to_end_matches_vct(models):
    """raw uint8 (bucket-padded, ragged lengths) -> SAD selection -> LRCN
    logits -> softmax, through both packages with the same weights."""
    flax_model, variables, torch_model = models
    rng = np.random.RandomState(7)
    raw = rng.randint(0, 256, size=(3, 2 * T, 16, 16, 3), dtype=np.uint8)
    lengths = np.array([8, 6, 3], np.int32)
    x_want = vct_sample(jnp.asarray(raw), T, method="sad", lengths=jnp.asarray(lengths))
    logits_want = np.asarray(flax_model.apply(variables, x_want))
    x_got = device_sample_clips(
        torch.from_numpy(raw), T, method="sad", lengths=torch.from_numpy(lengths)
    )
    with torch.no_grad():
        logits_got = torch_model(x_got).numpy()
    np.testing.assert_allclose(x_got.numpy(), np.asarray(x_want), rtol=1e-6, atol=0)
    np.testing.assert_allclose(logits_got, logits_want, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(
        torch.softmax(torch.from_numpy(logits_got), -1).numpy(),
        np.asarray(jax.nn.softmax(logits_want, -1)), atol=1e-4, rtol=1e-4,
    )


@pytest.mark.parametrize("sampling", ["ssim", "ssim_most_unique"])
def test_ssim_slice_end_to_end_matches_vct(models, sampling):
    """Decoded uint8 videos (short, bucket-padded, ragged) -> SSIM selection
    (the ssim_pair_scores plain version) -> LRCN logits -> softmax, through
    both packages with the same weights."""
    flax_model, variables, torch_model = models
    rng = np.random.RandomState(11)
    videos = [rng.randint(0, 256, size=(n, 16, 16, 3), dtype=np.uint8) for n in (3, 9, 17)]
    x_got = deployment.sample_decoded_clips(videos, sampling, T, device="cpu")
    clips = []
    for v in videos:  # vct's post-decode half of _load_with_device_sampling
        if len(v) <= T:
            clips.append(np.stack([v[i % len(v)] for i in range(T)]) / np.float32(255))
            continue
        bucket = vct_deployment._length_bucket(len(v), T)
        raw = np.concatenate([v, np.repeat(v[-1:], bucket - len(v), axis=0)])[None]
        clips.append(np.asarray(vct_sample(jnp.asarray(raw), T, method="ssim",
                                           lengths=jnp.asarray([len(v)], jnp.int32)))[0])
    x_want = np.stack(clips)
    np.testing.assert_allclose(x_got.numpy(), x_want, rtol=1e-6, atol=0)
    probs_want = vct_deployment.classify_videos(flax_model, variables, x_want, batch_size=2)
    probs_got = deployment.classify_videos(torch_model, x_got, batch_size=2, device="cpu")
    np.testing.assert_allclose(probs_got, probs_want, atol=1e-4, rtol=1e-4)
    with torch.no_grad():
        logits_got = torch_model(x_got).numpy()
    logits_want = np.asarray(flax_model.apply(variables, jnp.asarray(x_want)))
    np.testing.assert_allclose(logits_got, logits_want, atol=1e-4, rtol=1e-4)
