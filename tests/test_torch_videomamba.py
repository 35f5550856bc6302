"""vct_torch's VideoMamba against vct's, on the CPU, and the new model
families through the trainer, the CLI and the serving path.

A small VideoMamba (resnet18, 2 blocks, d_model 32, d_inner 64, n_state 16,
dt_rank 16, T=4, 32x32 frames): vct runs ``scan_impl="pallas"`` (its K3 in
interpret mode, as its own tests run it on the CPU), the port its plain
scan on CPU tensors. vct's variables are shaped by ``jax.eval_shape`` and
filled from a numpy seed (BatchNorm statistics off (0, 1)), then loaded into
the port by ``vct_torch.bridge.load_vct_variables``. Tolerance: logits and
features atol = rtol = 1e-4 (f32 on both sides, other summation orders).
Its five Adam steps against vct's trainer are a case of
tests/test_torch_train.py's trajectory test (``adam-mamba-extra3``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_train import _captured, _configs, _random_variables
from vct.train import engine as vct_engine
from vct_torch.bridge import load_vct_variables
from vct_torch.core.metrics_contract import extract_metrics
from vct_torch.models import build_model
from vct_torch.models.videomamba import VideoMamba
from vct_torch.serve.deployment import classify_and_display, load_model
from vct_torch.train import __main__ as cli

CLASSES = 4
NAMES = [f"class_{i}" for i in range(CLASSES)]
T_SEQ, HW = 4, 32
TOL = dict(atol=1e-4, rtol=1e-4)


def _overrides(**model):
    kw = {"model.model_family": "videomamba", "model.cnn_backbone": "resnet18",
          "model.vm_n_layer": "2", "model.vm_d_model": "32", "model.vm_d_inner": "64",
          "model.vm_n_state": "16", "model.vm_dt_rank": "16", "model.scan_impl": "pallas",
          "data.sequence_length": str(T_SEQ), "data.img_height": str(HW),
          "data.img_width": str(HW), "train.batch_size": "8"}
    kw.update({f"model.{k}": str(v) for k, v in model.items()})
    return kw


def _pair(**model):
    cfg_v, cfg_t = _configs(**_overrides(**model))
    vct_model = vct_engine.build_model(cfg_v.model, T_SEQ)
    port = build_model(cfg_t.model, T_SEQ, device="cpu")
    variables = _random_variables(vct_model, np.zeros((1, T_SEQ, HW, HW, 3), np.float32))
    load_vct_variables(port, variables)
    return vct_model, port, variables


def _clips(seed=1, n=2):
    return np.random.RandomState(seed).rand(n, T_SEQ, HW, HW, 3).astype(np.float32)


@pytest.mark.parametrize("mode", ["mean", "max", "last", "all"])
def test_videomamba_logits_match_vct(mode):
    vct_model, port, variables = _pair(vm_temporal_mode=mode)
    assert isinstance(port, VideoMamba) and port.supports_feature_cache
    x = _clips()
    want = np.asarray(jax.jit(vct_model.apply)(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == (2, CLASSES)
    np.testing.assert_allclose(got, want, **TOL)


def test_videomamba_features_only_and_from_features_match_vct():
    vct_model, port, variables = _pair()
    x = _clips(seed=2)
    feats_v = vct_model.apply(variables, jnp.asarray(x), features_only=True)
    want = vct_model.apply(variables, feats_v, from_features=True)
    with torch.no_grad():
        feats = port(torch.from_numpy(x), features_only=True)
        got = port(feats, from_features=True)
        whole = port(torch.from_numpy(x))
    assert feats.shape == (2, T_SEQ, 512)
    np.testing.assert_allclose(feats.numpy(), np.asarray(feats_v), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert torch.equal(got, whole)


@pytest.mark.parametrize("family,extra", [
    ("videomamba", {"train.feature_cache": "true"}),
    ("lrcn2", {"model.hidden_size": "6"}),
    ("td_cnn_lstm", {}),
])
def test_new_families_train_save_load_and_serve_on_the_cpu(tmp_path, family, extra):
    """``python -m vct_torch.train`` trains each new family (VideoMamba from
    cached features), saves it, ``load_model`` rebuilds it equal tensor for
    tensor, and ``classify_and_display`` serves it."""
    overrides = {**_overrides(model_family=family), **extra}
    argv = ["--device", "cpu", "--data.synthetic", "true", "--data.synthetic_samples", "10",
            *[a for k, v in overrides.items() for a in (f"--{k}", v)],
            "--train.epochs", "2", "--train.batch_size", "4",
            "--train.model_path", str(tmp_path / "ck")]
    rc, out = _captured(cli.main, argv)
    assert rc == 0 and sum(l.startswith("Epoch ") for l in out.splitlines()) == 2
    assert ("feature_cache: extracted" in out) == (family == "videomamba")
    assert 0.0 <= extract_metrics(out).accuracy <= 1.0
    model, class_names, cfg = load_model(str(tmp_path / "ck"), device="cpu")
    assert cfg.model.model_family == family and class_names == NAMES
    saved = torch.load(str(tmp_path / "ck" / "weights.pt"), weights_only=True)
    assert all(torch.equal(v, saved[k]) for k, v in model.state_dict().items())
    results = classify_and_display(model, _clips(seed=4, n=3), ["a", "b", "c"], class_names,
                                   batch_size=2, device="cpu")
    assert [r["video_name"] for r in results] == ["a", "b", "c"]
    assert all(abs(sum(r["scores"]) - 1.0) < 1e-5 for r in results)
