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
import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_weight_port as twp
from test_lrcn_port import CLASSES, HIDDEN, LAYERS, RNN_INPUT, T, TRefLRCNExact
from test_full_model_parity import _randomize_bn_stats
from test_weight_port import _fake_state_dict
from vct.core.config import Config as VctConfig
from vct.models import build_model as vct_build_model
from vct.models.backbones import build_backbone as vct_build_backbone
from vct.models.backbones.port import load_torch_backbone as vct_load_torch_backbone
from vct.models.backbones.port import load_torch_resnet as vct_load_torch_resnet
from vct.models.backbones.resnet import resnet18 as vct_resnet18
from vct.models.lrcn_port import port_reference_lrcn as vct_port_reference_lrcn
from vct.models.lrcn_port import port_reference_videomamba as vct_port_reference_videomamba
from vct_torch.bridge import load_vct_variables
from vct_torch.core.config import Config
from vct_torch.models import build_model
from vct_torch.models.backbones import build_backbone
from vct_torch.models.backbones.port import (
    PORTERS,
    load_state_dict_file,
    load_torch_backbone,
    load_torch_mobilenet_v2,
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
    with pytest.raises(KeyError, match="No weight porter for backbone 'resnext50'"):
        load_torch_backbone("resnext50", resnet18(), {})  # a name no package registers


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
    """Both importers are ported (the S2VT one with captioning, ROADMAP
    Queue 1 item 6) and refuse an LRCN's state_dict, naming a tensor the
    layout needs."""
    from vct_torch.caption.train import build_captioner
    from vct_torch.core.config import CaptionConfig

    s2vt = build_captioner(CaptionConfig(cnn_backbone="resnet18", cnn_output_size=8,
                                         hidden_size=8), 11, device="cpu")
    with pytest.raises(KeyError, match="cnn.fc.weight"):
        port_reference_s2vt(s2vt, _reference("gru", "all", "multiclass").state_dict())
    cfg_v, cfg_t = _vm_cfg("multiclass")
    with pytest.raises(KeyError, match="adapt.weight"):
        port_reference_videomamba(build_model(cfg_t.model, T, device="cpu"),
                                  _reference("gru", "all", "multiclass").state_dict(),
                                  cfg_t.model)


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

    with pytest.raises(SystemExit):  # a family no porter knows
        port_reference.main(args + ["--device", "cpu", "--model_family", "s2vt"])
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
    with pytest.raises(ValueError, match="python convert_vct_checkpoint.py SRC DST"):
        load_model(path, device="cpu")
    state_dict, _, _, _ = load_checkpoint(save_checkpoint(path, model.state_dict(), cfg, ["a"]))
    bad = copy.copy(state_dict)
    bad["head.fcb.bias"] = torch.zeros(5)
    save_checkpoint(path, bad, cfg, ["a"])
    with pytest.raises(ValueError, match="head.fcb.bias"):
        load_model(path, device="cpu")
    with pytest.raises(FileNotFoundError):
        load_model(str(tmp_path / "nowhere"), device="cpu")


# ---------------------------------------------------------------------------
# the other torchvision families


def _inception_v3_keys():
    """torchvision's inception_v3 layout: channel shapes from vct's tree
    shaped by ``jax.eval_shape`` (no Flax init), module names held against
    tests/test_weight_port.py's independent list of torchvision's."""
    flax_bb, _ = vct_build_backbone("inception_v3")
    params = _eval_shapes(flax_bb, np.zeros((1, 75, 75, 3), np.float32))["params"]
    keys = {}
    for stem, node in params.items():
        for dotted, inner in ([(stem, node)] if "conv" in node
                              else [(f"{stem}.{b}", node[b]) for b in node]):
            kh, kw, i, o = inner["conv"]["kernel"].shape
            keys[f"{dotted}.conv.weight"] = (o, i, kh, kw)
            twp._bn_keys(keys, f"{dotted}.bn", o)
    assert ({k[:-len(".conv.weight")] for k in keys if k.endswith(".conv.weight")}
            == twp._torchvision_inception_module_names())
    keys.update({"fc.weight": (1000, 2048), "fc.bias": (1000,),
                 "AuxLogits.conv0.conv.weight": (128, 768, 1, 1),
                 "AuxLogits.fc.weight": (1000, 768), "AuxLogits.fc.bias": (1000,)})
    twp._bn_keys(keys, "AuxLogits.conv0.bn", 128)
    return keys


# name -> (torchvision key list, a frame size the backbone takes)
FAMILIES = {
    "mobilenet_v2": (twp._mobilenet_v2_keys, 32),
    "densenet121": (twp._densenet121_keys, 32),
    "vgg16": (twp._vgg16_keys, 32),
    "alexnet": (twp._alexnet_keys, 64),
    "efficientnet_b0": (twp._efficientnet_b0_keys, 32),
    "inception_v3": (_inception_v3_keys, 75),
}


@functools.lru_cache(maxsize=None)
def _family_inputs(name):
    """The seeded torchvision state_dict of ``name`` and vct's variables
    shapes, shared by the cases (copy the dict before changing it)."""
    keygen, size = FAMILIES[name]
    shapes = _eval_shapes(vct_build_backbone(name)[0], np.zeros((1, size, size, 3)))
    return twp._synth_state_dict(keygen()), shapes


def _no_counts(state):
    return {k: v for k, v in state.items() if not k.endswith("num_batches_tracked")}


def test_every_registered_backbone_has_a_porter():
    from vct.models.backbones.port import PORTERS as VCT_PORTERS

    assert sorted(PORTERS) == sorted(VCT_PORTERS)


@pytest.mark.parametrize("name", FAMILIES)
def test_family_port_matches_vcts_porter(name):
    """The same seeded torchvision state_dict through vct's porter (then the
    bridge) and through the port's: bit-equal tensor for tensor."""
    sd, shapes = _family_inputs(name)
    ported = vct_load_torch_backbone(name, shapes, sd)
    ours = load_torch_backbone(name, build_backbone(name)[0], sd)
    via_vct = load_vct_variables(build_backbone(name)[0], ported)
    _assert_state_equal(_no_counts(ours.state_dict()), _no_counts(via_vct.state_dict()))


def _bad_family_dict(name, case):
    sd = dict(_family_inputs(name)[0])
    victim = sorted(k for k in sd if k.endswith(".weight")
                    and not k.startswith(("classifier", "fc.", "AuxLogits")))[3]
    if case == "missing":
        del sd[victim]
        return sd, KeyError, victim
    if case == "extra":
        sd["features.99.weight"] = np.zeros((1, 1, 1, 1), np.float32)
        return sd, ValueError, "Unconsumed"
    sd[victim] = np.zeros((sd[victim].shape[0] + 1,) + sd[victim].shape[1:], np.float32)
    return sd, ValueError, victim


@pytest.mark.parametrize("case", ["missing", "extra", "wrong_shape"])
@pytest.mark.parametrize("name", FAMILIES)
def test_family_port_refuses_bad_dicts_and_writes_nothing(name, case):
    sd, error, match = _bad_family_dict(name, case)
    with pytest.raises(error):
        vct_load_torch_backbone(name, _family_inputs(name)[1], sd)
    backbone = build_backbone(name)[0]
    before = _state(backbone)
    with pytest.raises(error, match=re.escape(match)):
        load_torch_backbone(name, backbone, sd)
    _assert_state_equal(_state(backbone), before)


def test_backbone_weights_option_ports_a_mobilenet_v2(tmp_path):
    """``model.backbone_weights`` for the sweep winner's backbone: the
    LRCN's ``cnn_backbone`` gets the porter's tensors, the head keeps its own."""
    sd = _family_inputs("mobilenet_v2")[0]
    path = str(tmp_path / "mobilenet_v2.npz")
    np.savez(path, **sd)
    cfg = _small_cfg(cnn_backbone="mobilenet_v2")
    fresh = engine.Trainer(cfg, ["a", "b", "c", "d"], device="cpu").model.state_dict()
    trainer = engine.Trainer(cfg.replace(**{"model.backbone_weights": path}),
                             ["a", "b", "c", "d"], device="cpu")
    trainer.init_state()
    want = load_torch_mobilenet_v2(build_backbone("mobilenet_v2")[0], sd).state_dict()
    for name, value in trainer.model.state_dict().items():
        if name.startswith("cnn_backbone."):
            assert torch.equal(value, want[name[len("cnn_backbone."):]]), name
        else:
            assert torch.equal(value, fresh[name]), name


# ---------------------------------------------------------------------------
# the reference VideoMamba

VM = {"vm_d_model": 12, "vm_d_inner": 24, "vm_n_state": 4, "vm_dt_rank": 4, "vm_n_layer": 2}


def _vm_cfg(classif_mode, temporal_mode="mean"):
    overrides = {"model.model_family": "videomamba", "model.num_classes": str(CLASSES),
                 "model.cnn_backbone": "resnet18", "model.classif_mode": classif_mode,
                 "model.vm_temporal_mode": temporal_mode, "data.sequence_length": str(T),
                 "data.img_height": str(HW), "data.img_width": str(HW),
                 **{f"model.{k}": str(v) for k, v in VM.items()}}
    return VctConfig().replace(**overrides), Config().replace(**overrides)


def _reference_videomamba_keys(classif_mode, pooled):
    """The reference VideoMamba's state_dict layout (``lrcn/videomamba.py:
    332-386``) at the VM sizes: key -> shape."""
    keys = {f"cnn_backbone.{k}": v for k, v in twp._torchvision_resnet18_keys().items()
            if not k.startswith("fc.")}
    d, di, n, r = VM["vm_d_model"], VM["vm_d_inner"], VM["vm_n_state"], VM["vm_dt_rank"]
    keys.update({"adapt.weight": (d, 512), "adapt.bias": (d,), "norm_f.weight": (d,)})
    for i in range(VM["vm_n_layer"]):
        m = f"layers.{i}.mixer"
        keys.update({f"layers.{i}.norm.weight": (d,), f"{m}.A_log": (di, n), f"{m}.D": (di,),
                     f"{m}.in_proj.weight": (2 * di, d), f"{m}.in_proj.bias": (2 * di,),
                     f"{m}.conv1d.weight": (di, 1, 3), f"{m}.conv1d.bias": (di,),
                     f"{m}.x_proj.weight": (r + 2 * n, di), f"{m}.dt_proj.weight": (di, r),
                     f"{m}.dt_proj.bias": (di,), f"{m}.out_proj.weight": (d, di),
                     f"{m}.out_proj.bias": (d,)})
    if classif_mode == "multiclass":
        keys.update({"classifier.weight": (CLASSES, pooled), "classifier.bias": (CLASSES,)})
    else:
        for i in range(CLASSES):
            keys.update({f"classifier.{i}.weight": (1, pooled), f"classifier.{i}.bias": (1,)})
    return keys


def _reference_videomamba_sd(classif_mode, pooled=VM["vm_d_model"], seed=5):
    sd = twp._synth_state_dict(_reference_videomamba_keys(classif_mode, pooled), seed=seed)
    for key in sd:  # A = -exp(A_log) stays a decay; the norms' weights near 1
        if key.endswith("A_log"):
            sd[key] = np.log(np.abs(sd[key]) * 20 + 0.5).astype(np.float32)
        elif key.endswith("norm.weight") or key == "norm_f.weight":
            sd[key] = (1.0 + sd[key]).astype(np.float32)
    return sd


@pytest.mark.parametrize("classif_mode", ["multiclass", "multiple_binary"])
def test_port_reference_videomamba_matches_vcts_port(classif_mode):
    sd = _reference_videomamba_sd(classif_mode)
    x = _clips()
    cfg_v, cfg_t = _vm_cfg(classif_mode)
    vct_model = vct_build_model(cfg_v.model, T)
    vct_ported = vct_port_reference_videomamba(_eval_shapes(vct_model, x[:1]), sd, cfg_v.model)
    want = np.asarray(jax.jit(vct_model.apply)(vct_ported, jnp.asarray(x)))
    model = build_model(cfg_t.model, T, device="cpu")
    assert port_reference_videomamba(model, sd, cfg_t.model) is model
    via_vct = load_vct_variables(build_model(cfg_t.model, T, device="cpu"), vct_ported)
    _assert_state_equal(_no_counts(model.state_dict()), _no_counts(via_vct.state_dict()))
    assert torch.equal(model.layer_1.mixer.conv.weight,
                       torch.from_numpy(sd["layers.1.mixer.conv1d.weight"]))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def _bad_videomamba_dicts():
    sd = _reference_videomamba_sd("multiclass")
    return {
        "missing": ({k: v for k, v in sd.items() if k != "layers.1.mixer.D"}, KeyError,
                    "layers.1.mixer.D"),
        "extra": ({**sd, "layers.2.norm.weight": sd["layers.0.norm.weight"]}, ValueError,
                  "Unconsumed"),
        "missing_backbone": ({k: v for k, v in sd.items()
                              if k != "cnn_backbone.layer2.0.conv1.weight"}, KeyError,
                             "layer2.0.conv1"),
        # sized for temporal_mode "all": the classifier takes d_model * T
        "shape": (_reference_videomamba_sd("multiclass", pooled=VM["vm_d_model"] * T),
                  ValueError, "classifier.weight"),
        "binary_heads": (_reference_videomamba_sd("multiple_binary"), KeyError,
                         "classifier.weight"),
    }


@pytest.mark.parametrize("case", ["missing", "extra", "missing_backbone", "shape",
                                  "binary_heads"])
def test_port_reference_videomamba_refuses_what_the_config_does_not_describe(case):
    sd, error, match = _bad_videomamba_dicts()[case]
    cfg_v, cfg_t = _vm_cfg("multiclass")
    with pytest.raises((KeyError, ValueError)):
        vct_port_reference_videomamba(_eval_shapes(vct_build_model(cfg_v.model, T),
                                                   _clips()[:1]), sd, cfg_v.model)
    model = build_model(cfg_t.model, T, device="cpu")
    before = _state(model)
    with pytest.raises(error, match=re.escape(match)):
        port_reference_videomamba(model, sd, cfg_t.model)
    _assert_state_equal(_state(model), before)


def test_port_reference_cli_ports_a_videomamba_for_load_model(tmp_path, capsys):
    sd = _reference_videomamba_sd("multiple_binary")
    sd_path = str(tmp_path / "ref_videomamba.npz")
    np.savez(sd_path, **sd)
    out = str(tmp_path / "ported")
    args = ["--state_dict", sd_path, "--out", out, "--model_family", "videomamba",
            "--num_classes", str(CLASSES), "--sequence_length", str(T), "--cnn_backbone",
            "resnet18", "--classif_mode", "multiple_binary", "--img_height", str(HW),
            "--img_width", str(HW), "--scan_impl", "scan", "--device", "cpu",
            *[a for k, v in VM.items() for a in (f"--{k}", str(v))]]
    assert port_reference.main(args) == 0
    assert "Ported checkpoint written to" in capsys.readouterr().out
    model, _, cfg = load_model(out, device="cpu")
    assert (cfg.model.model_family, cfg.model.vm_d_inner, cfg.model.scan_impl) == (
        "videomamba", VM["vm_d_inner"], "scan")
    _, cfg_t = _vm_cfg("multiple_binary")
    direct = port_reference_videomamba(build_model(cfg_t.model, T, device="cpu"), sd,
                                       cfg_t.model)
    x = torch.from_numpy(_clips())
    with torch.no_grad():
        np.testing.assert_allclose(model(x).numpy(), direct(x).numpy(), atol=1e-6, rtol=1e-6)
