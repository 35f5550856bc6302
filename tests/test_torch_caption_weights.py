"""vct_torch's reference-S2VT importer against vct's, on the CPU.

A seeded state_dict in the reference VideoAnalysisModel's layout
(``chip_smoke._reference_s2vt_keys``: the torchvision backbone under
``cnn.model`` and again under ``cnn.feature_extractor``, ``cnn.fc``, the
encoder and the decoder) goes through
``vct_torch.models.lrcn_port.port_reference_s2vt`` and through
``vct/models/lrcn_port.py::port_reference_s2vt`` followed by the bridge: the
two ports hold equal tensors and give equal log-probs, and the port's
within 1e-5 of vct's. A state_dict the model does not describe is refused
and nothing is written.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import torch_caption_common as common
from vct.caption.models import S2VTModel as VctS2VTModel
from vct.models.lrcn_port import port_reference_s2vt as vct_port_reference_s2vt
from vct_torch.bridge import load_vct_variables
from vct_torch.caption.train import build_captioner
from vct_torch.models.lrcn_port import port_reference_s2vt

OUT, HID = 16, 16


def _state_dict(backbone="resnet18", seed=4):
    keys = chip_smoke._reference_s2vt_keys(backbone, OUT, HID, len(common.vocab()))
    return chip_smoke._seeded_state_dict(torch, keys, seed)


def _model(**extra):
    _, cfg = common.configs("s2vt", **extra)
    return build_captioner(cfg, len(common.vocab()), device="cpu")


def _state(model):
    return {k: v.clone() for k, v in model.state_dict().items()}


def test_port_reference_s2vt_matches_vct():
    sd = _state_dict()
    assert sum(k.startswith("cnn.feature_extractor.") for k in sd) == sum(
        k.startswith("cnn.model.") and not k.startswith("cnn.model.fc.") for k in sd)
    videos, captions = common.inputs()
    vct_model = VctS2VTModel(vocab_size=len(common.vocab()), cnn_backbone="resnet18",
                             cnn_output_size=OUT, hidden_size=HID, max_len=common.MAX_LEN)
    shapes = jax.eval_shape(vct_model.init, jax.random.PRNGKey(0), jnp.asarray(videos[:1]),
                            jnp.asarray(captions[:1]))
    ported = vct_port_reference_s2vt(shapes, sd)  # strict: consumes every key
    via_vct = load_vct_variables(_model(), ported)
    ours = port_reference_s2vt(_model(), sd)
    theirs = via_vct.state_dict()
    for k, v in ours.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(v, theirs[k]), k
    want = np.asarray(vct_model.apply(ported, jnp.asarray(videos), jnp.asarray(captions)))
    with torch.no_grad():
        got = ours(torch.from_numpy(videos), torch.from_numpy(captions)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def _bad(case):
    sd = _state_dict()
    if case == "extra":
        sd["decoder.gru.weight_ih_l1"] = torch.zeros(3 * HID, HID)
        return sd, ValueError, "Unconsumed"
    if case == "missing":
        del sd["decoder.out.bias"]
        return sd, KeyError, "decoder.out.bias"
    if case == "shape":
        sd["encoder.embedding.weight"] = torch.zeros(HID, OUT + 1)
        return sd, ValueError, "encoder.embedding.weight"
    if case == "backbone":  # a resnet50 checkpoint for the resnet18 model
        return _state_dict("resnet50"), ValueError, "shape"
    raise KeyError(case)


@pytest.mark.parametrize("case", ["extra", "missing", "shape", "backbone"])
def test_port_reference_s2vt_refuses_what_the_model_does_not_describe(case):
    sd, error, match = _bad(case)
    model = _model()
    before = _state(model)
    with pytest.raises(error, match=match):
        port_reference_s2vt(model, sd)
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k  # nothing was written


def test_port_reference_s2vt_refuses_the_1s2vt_variant():
    """The reference's v2 layout has one GRU layer a side; a 4-layer model
    has tensors no key describes."""
    with pytest.raises(KeyError, match="decoder.gru_b_hh_l1"):
        port_reference_s2vt(_model(encoder_layers=4), _state_dict())
