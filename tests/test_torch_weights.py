"""vct_torch's weight import against vct's, on the CPU: torchvision
backbone state_dicts (``vct_torch.models.backbones.port``), whole
reference-LRCN state_dicts (``vct_torch.models.lrcn_port``), the
``port_reference`` CLI and ``load_model``.

The state_dicts come from a numpy seed (resnet18: the torchvision key list
of tests/test_weight_port.py, written out independently of both porters)
or from the reference-layout torch LRCN of tests/test_lrcn_port.py. Each is
ported by vct and by the port; vct's result is carried into the port's
layout by ``vct_torch.bridge.load_vct_variables``, where the two must be
bit-equal tensor for tensor (both copy the same numbers: no arithmetic).
Tolerances of the forwards (f32, other summation orders): resnet18
features atol = rtol = 1e-5 against vct; LRCN logits atol 1e-4 against
vct's port and 1e-3 against the torch reference (vct's own bound).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_lrcn_port import CLASSES, HIDDEN, LAYERS, RNN_INPUT, T, TRefLRCNExact
from test_full_model_parity import _randomize_bn_stats
from test_weight_port import _fake_state_dict
from vct.core.config import Config as VctConfig
from vct.models import build_model as vct_build_model
from vct.models.backbones.port import load_torch_resnet as vct_load_torch_resnet
from vct.models.backbones.resnet import resnet18 as vct_resnet18
from vct.models.lrcn_port import port_reference_lrcn as vct_port_reference_lrcn
from vct_torch.bridge import load_vct_variables
from vct_torch.core.config import Config
from vct_torch.models import build_model
from vct_torch.models.backbones.port import (
    load_state_dict_file,
    load_torch_backbone,
    load_torch_resnet,
    port_backbone_into_model,
)
from vct_torch.models.backbones.resnet import resnet18, resnet50
from vct_torch.models.lrcn_port import (
    port_reference_lrcn,
    port_reference_s2vt,
    port_reference_videomamba,
)
from vct_torch.serve.deployment import load_model
from vct_torch.tools import port_reference
from vct_torch.train import engine
from vct_torch.train.checkpoint import load_checkpoint, save_checkpoint

HW = 32


def _eval_shapes(module, x):
    """vct's variables tree as shapes only (no Flax init runs)."""
    return jax.eval_shape(module.init, jax.random.PRNGKey(0), jnp.asarray(x))


def _state(module):
    return {k: v.clone() for k, v in module.state_dict().items()}


def _assert_state_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


# ---------------------------------------------------------------------------
# torchvision backbones


def test_resnet18_port_matches_vcts_porter():
    sd = _fake_state_dict()
    x = np.random.RandomState(1).rand(2, 64, 64, 3).astype(np.float32)
    vct_model = vct_resnet18()
    ported = vct_load_torch_resnet(_eval_shapes(vct_model, x[:1]), sd)
    want = np.asarray(vct_model.apply(ported, jnp.asarray(x)))

    ours = load_torch_resnet(resnet18().eval(), sd)
    via_vct = load_vct_variables(resnet18(), ported)
    _assert_state_equal({k: v for k, v in ours.state_dict().items()
                         if not k.endswith("num_batches_tracked")},
                        {k: v for k, v in via_vct.state_dict().items()
                         if not k.endswith("num_batches_tracked")})
    assert torch.equal(ours.conv1.weight, torch.from_numpy(sd["conv1.weight"]))  # OIHW both sides
    assert torch.equal(ours.layer2_0.downsample_conv.weight,
                       torch.from_numpy(sd["layer2.0.downsample.0.weight"]))
    assert torch.equal(ours.layer4_1.bn2.running_var,
                       torch.from_numpy(sd["layer4.1.bn2.running_var"]))
    with torch.no_grad():
        got = ours(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    assert got.shape == (2, 512)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def _bad_dicts():
    missing = _fake_state_dict()
    del missing["layer3.0.conv1.weight"]
    extra = _fake_state_dict()
    extra["layer9.0.conv1.weight"] = np.zeros((1, 1, 1, 1), np.float32)
    wrong = _fake_state_dict()
    wrong["layer1.1.bn2.running_mean"] = np.zeros(65, np.float32)
    return {"missing": (missing, KeyError, "layer3.0.conv1"),
            "extra": (extra, ValueError, "Unconsumed"),
            "wrong_shape": (wrong, ValueError, "layer1.1.bn2.running_mean")}


@pytest.mark.parametrize("case", ["missing", "extra", "wrong_shape"])
def test_resnet_port_refuses_bad_dicts_and_writes_nothing(case):
    sd, error, match = _bad_dicts()[case]
    with pytest.raises(error, match=match):
        vct_load_torch_resnet(_eval_shapes(vct_resnet18(), np.ones((1, 32, 32, 3))), sd)
    backbone = resnet18()
    before = _state(backbone)
    with pytest.raises(error, match=match):
        load_torch_resnet(backbone, sd)
    _assert_state_equal(_state(backbone), before)


def test_resnet_port_refuses_another_depth_and_unported_families():
    with pytest.raises((KeyError, ValueError)):
        load_torch_resnet(resnet50(), _fake_state_dict())  # resnet18-shaped
    with pytest.raises(NotImplementedError, match="Queue 1 item 5"):
        load_torch_backbone("mobilenet_v2", resnet18(), {})


def _small_cfg(**model):
    kw = {"model.cnn_backbone": "resnet18", "model.rnn_type": "gru",
          "model.rnn_input_size": "8", "model.hidden_size": "6", "model.rnn_layer": "2",
          "data.sequence_length": "4", "data.img_height": str(HW), "data.img_width": str(HW)}
    kw.update({f"model.{k}": str(v) for k, v in model.items()})
    return Config().replace(**kw)


@pytest.mark.parametrize("fmt", ["pth", "npz"])
def test_backbone_weights_option_ports_into_the_backbone_only(tmp_path, fmt):
    sd = _fake_state_dict()
    path = str(tmp_path / f"resnet18.{fmt}")
    if fmt == "pth":
        torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}, path)
    else:
        np.savez(path, **sd)
    assert set(load_state_dict_file(path)) == set(sd)
    cfg = _small_cfg()
    fresh = engine.Trainer(cfg, ["a", "b", "c", "d"], device="cpu").model
    trainer = engine.Trainer(cfg.replace(**{"model.backbone_weights": path}),
                             ["a", "b", "c", "d"], device="cpu")
    trainer.init_state()
    want = load_torch_resnet(resnet18(), sd).state_dict()
    for name, value in trainer.model.state_dict().items():
        if name.startswith("cnn_backbone."):
            assert torch.equal(value, want[name[len("cnn_backbone."):]]), name
        else:
            assert torch.equal(value, fresh.state_dict()[name]), name  # the head is untouched
    with pytest.raises(KeyError, match="no 'cnn'"):
        port_backbone_into_model(trainer.model, "resnet18", sd, module_name="cnn")


# ---------------------------------------------------------------------------
# the reference LRCN


def _ref_cfg(rnn_type, rnn_out, classif_mode):
    overrides = {
        "model.num_classes": str(CLASSES), "model.cnn_backbone": "resnet18",
        "model.rnn_type": rnn_type, "model.rnn_input_size": str(RNN_INPUT),
        "model.rnn_layer": str(LAYERS), "model.hidden_size": str(HIDDEN),
        "model.rnn_out": rnn_out, "model.classif_mode": classif_mode,
        "data.sequence_length": str(T), "data.img_height": str(HW), "data.img_width": str(HW),
    }
    return VctConfig().replace(**overrides), Config().replace(**overrides)


def _reference(rnn_type, rnn_out, classif_mode, seed=0):
    torch.manual_seed(seed)
    with torch.no_grad():
        t_model = TRefLRCNExact(rnn_type, rnn_out, classif_mode)
        _randomize_bn_stats(t_model)
    return t_model.eval()


def _clips(seed=1):
    return np.random.RandomState(seed).rand(2, T, HW, HW, 3).astype(np.float32)


@pytest.mark.parametrize("classif_mode", ["multiclass", "multiple_binary"])
@pytest.mark.parametrize("rnn_out", ["all", "last"])
@pytest.mark.parametrize("rnn_type", ["lstm", "gru", "mamba"])
def test_port_reference_lrcn_matches_vcts_port(rnn_type, rnn_out, classif_mode):
    t_model = _reference(rnn_type, rnn_out, classif_mode)
    x = _clips()
    with torch.no_grad():
        reference = t_model(torch.from_numpy(x).permute(0, 1, 4, 2, 3)).numpy()
    cfg_v, cfg_t = _ref_cfg(rnn_type, rnn_out, classif_mode)
    vct_model = vct_build_model(cfg_v.model, T)
    vct_ported = vct_port_reference_lrcn(_eval_shapes(vct_model, x[:1]), t_model.state_dict(),
                                         cfg_v.model)
    want = np.asarray(jax.jit(vct_model.apply)(vct_ported, jnp.asarray(x)))

    model = build_model(cfg_t.model, T, device="cpu")
    assert port_reference_lrcn(model, t_model.state_dict(), cfg_t.model) is model
    via_vct = load_vct_variables(build_model(cfg_t.model, T, device="cpu"), vct_ported)
    _assert_state_equal(
        {k: v for k, v in model.state_dict().items() if not k.endswith("num_batches_tracked")},
        {k: v for k, v in via_vct.state_dict().items() if not k.endswith("num_batches_tracked")})
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    np.testing.assert_allclose(got, reference, atol=1e-3, rtol=0)


def _bad_reference_dicts():
    sd = dict(_reference("lstm", "all", "multiclass").state_dict())
    reverse = dict(sd)
    for kind in ("weight_ih_l0", "weight_hh_l0", "bias_ih_l0", "bias_hh_l0"):
        reverse[f"rnn.{kind}_reverse"] = sd[f"rnn.{kind}"].clone()
    extra = {**sd, "mystery.weight": torch.zeros(3)}
    missing = {k: v for k, v in sd.items() if k != "fcb.bias"}
    no_backbone_tensor = {k: v for k, v in sd.items() if k != "cnn_backbone.layer1.0.conv2.weight"}
    wrong_head = dict(_reference("lstm", "last", "multiclass").state_dict())  # sized for "last"
    return {"reverse_half": (reverse, ValueError, "Unconsumed"),
            "extra": (extra, ValueError, "Unconsumed"),
            "missing": (missing, KeyError, "fcb.bias"),
            "missing_backbone": (no_backbone_tensor, KeyError, "layer1.0.conv2"),
            "shape": (wrong_head, ValueError, "shape")}


@pytest.mark.parametrize("case", ["reverse_half", "extra", "missing", "missing_backbone", "shape"])
def test_port_reference_lrcn_refuses_what_the_config_does_not_describe(case):
    sd, error, match = _bad_reference_dicts()[case]
    cfg_v, cfg_t = _ref_cfg("lstm", "all", "multiclass")
    with pytest.raises((KeyError, ValueError)):
        vct_port_reference_lrcn(_eval_shapes(vct_build_model(cfg_v.model, T), _clips()[:1]), sd,
                                cfg_v.model)
    model = build_model(cfg_t.model, T, device="cpu")
    before = _state(model)
    with pytest.raises(error, match=match):
        port_reference_lrcn(model, sd, cfg_t.model)
    _assert_state_equal(_state(model), before)  # nothing was written


def test_videomamba_and_s2vt_importers_name_the_roadmap():
    with pytest.raises(NotImplementedError, match="Queue 1 item 5"):
        port_reference_videomamba(None, {}, None)
    with pytest.raises(NotImplementedError, match="Queue 1 item 6"):
        port_reference_s2vt(None, {})


def test_port_reference_cli_then_load_model_on_the_cpu(tmp_path, monkeypatch, capsys):
    t_model = _reference("gru", "all", "multiclass")
    sd_path = str(tmp_path / "ref_lrcn.pth")
    torch.save(t_model.state_dict(), sd_path)
    out = str(tmp_path / "ported")
    args = ["--state_dict", sd_path, "--out", out, "--num_classes", str(CLASSES),
            "--sequence_length", str(T), "--cnn_backbone", "resnet18", "--rnn_type", "gru",
            "--rnn_input_size", str(RNN_INPUT), "--rnn_layer", str(LAYERS),
            "--hidden_size", str(HIDDEN), "--rnn_out", "all", "--img_height", str(HW),
            "--img_width", str(HW), "--classes", "a,b,c,d"]
    assert port_reference.main(args + ["--device", "cpu"]) == 0
    assert "Ported checkpoint written to" in capsys.readouterr().out
    model, class_names, cfg = load_model(out, device="cpu")
    assert class_names == ["a", "b", "c", "d"] and not model.training
    assert (cfg.model.rnn_type, cfg.model.hidden_size) == ("gru", HIDDEN)
    _, cfg_t = _ref_cfg("gru", "all", "multiclass")
    direct = port_reference_lrcn(build_model(cfg_t.model, T, device="cpu"), t_model.state_dict(),
                                 cfg_t.model)
    x = torch.from_numpy(_clips())
    with torch.no_grad():
        assert torch.equal(model(x), direct(x))
        want = t_model(x.permute(0, 1, 4, 2, 3))
    np.testing.assert_allclose(model(x).detach().numpy(), want.numpy(), atol=1e-3, rtol=0)

    with pytest.raises(NotImplementedError, match="Queue 1 item 5"):
        port_reference.main(args + ["--device", "cpu", "--model_family", "videomamba"])
    with pytest.raises(SystemExit):
        port_reference.main(args[:-1] + ["a,b", "--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_reference.main(args)  # the card by default
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_model(out)


def test_load_model_refuses_other_frameworks_and_mismatched_weights(tmp_path):
    import json

    cfg = _small_cfg()
    model = build_model(cfg.model, 4, device="cpu")
    path = save_checkpoint(str(tmp_path / "ck"), model.state_dict(), cfg, ["a", "b", "c", "d"])
    manifest = json.loads((tmp_path / "ck" / "manifest.json").read_text())
    (tmp_path / "ck" / "manifest.json").write_text(json.dumps({**manifest, "framework": "vct"}))
    with pytest.raises(ValueError, match="Queue 1 item 4"):
        load_model(path, device="cpu")
    state_dict, _, _, _ = load_checkpoint(save_checkpoint(path, model.state_dict(), cfg, ["a"]))
    bad = copy.copy(state_dict)
    bad["head.fcb.bias"] = torch.zeros(5)
    save_checkpoint(path, bad, cfg, ["a"])
    with pytest.raises(ValueError, match="head.fcb.bias"):
        load_model(path, device="cpu")
    with pytest.raises(FileNotFoundError):
        load_model(str(tmp_path / "nowhere"), device="cpu")
