"""vct_torch's AOT servable (vct_torch/serve/aot.py) against vct's, on the CPU.

The same seeded weights (a vct variables tree, carried into the port by the
bridge) are exported by both packages: vct's ``export_servable`` (StableHLO,
its Pallas kernels in interpret mode) and the port's (``torch.export``, the
kernels as ``torch.ops.vct_torch.*`` operators whose CPU implementation is
the plain version). On the same clips, five of them with buckets (2, 4) so a
full chunk and a padded tail both run, the port's probabilities are within
1e-4 of vct's and within 1e-6 of the port's eager forward, for the Mamba
LRCN dense and raw (SAD, SSIM), an LSTM head (K2) and a bidirectional GRU
head (K5); each exported graph holds the operators its model reaches.
Then the export CLI, the deployment CLI and the worker with an artifact
against vct's, every refusal, the operators under ``torch.library.opcheck``,
the no-zoo import check in a fresh interpreter, and the motion dataset.
"""

from __future__ import annotations

import collections
import json
import os
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vct.core.config import ModelConfig as VctModelConfig
from vct.data import synthetic as vct_synthetic
from vct.models import build_model as vct_build_model
from vct.serve import aot as vct_aot
from vct_torch.bridge import load_vct_variables
from vct_torch.core.config import ModelConfig
from vct_torch.data import synthetic
from vct_torch.data.preprocess import device_sample_clips
from vct_torch.models import build_model
from vct_torch.serve import aot

T, HW, RAW_LEN = 4, 16, 8
BUCKETS = (2, 4)
N = 5  # a full chunk of 4 and a tail of 1 padded to 2
CLASSES = ["calm", "fight", "other"]
BASE = dict(num_classes=3, cnn_backbone="resnet18", rnn_input_size=8, scan_impl="pallas")
MODELS = {
    "mamba": dict(BASE, rnn_type="mamba", rnn_layer=2),
    "lstm": dict(BASE, rnn_type="lstm", hidden_size=8, rnn_layer=2),
    "bigru": dict(BASE, rnn_type="gru", hidden_size=8, rnn_layer=2, bidirectional=True),
}
# (model, device_sampling): the operators each exported graph must hold.
CASES = {
    ("mamba", None): {"selective_scan": 2},
    ("mamba", "sad"): {"selective_scan": 2, "pair_scores": 1},
    ("mamba", "ssim"): {"selective_scan": 2, "ssim_pair_scores": 1},
    ("lstm", None): {"rnn_stack": 1},
    ("bigru", None): {"rnn_scan": 4},
}
IDS = [f"{m}-{s or 'dense'}" for m, s in CASES]


@pytest.fixture(scope="module")
def nets():
    """{name: (vct model, variables, the port's model with its weights)}."""
    out = {}
    for name, cfg in MODELS.items():
        flax_model = vct_build_model(VctModelConfig(**cfg), T)
        x0 = jnp.zeros((1, T, HW, HW, 3), jnp.float32)
        variables = jax.tree_util.tree_map(np.asarray,
                                           flax_model.init(jax.random.PRNGKey(1), x0))
        model = build_model(ModelConfig(**cfg), T, device="cpu")
        load_vct_variables(model, variables)
        out[name] = (flax_model, variables, model)
    return out


@pytest.fixture(scope="module")
def artifacts(nets, tmp_path_factory):
    """Lazily exported (vct's artifact, the port's) for each case."""
    root = tmp_path_factory.mktemp("aot")
    cache = {}

    def get(case):
        if case not in cache:
            name, method = case
            flax_model, variables, model = nets[name]
            tag = f"{name}_{method or 'dense'}"
            raw_len = RAW_LEN if method else None
            paths = (str(root / f"{tag}_vct.vctaot"), str(root / f"{tag}.vctaot"))
            # vct's side in one bucket: its export and compile dominate the file.
            vct_aot.export_servable(flax_model, variables, CLASSES, (T, HW, HW, 3), paths[0],
                                    batch_sizes=BUCKETS[-1:], device_sampling=method,
                                    raw_len=raw_len)
            aot.export_servable(model, CLASSES, (T, HW, HW, 3), paths[1], batch_sizes=BUCKETS,
                                device_sampling=method, raw_len=raw_len)
            cache[case] = paths
        return cache[case]

    return get


def _inputs(method, seed=0):
    rng = np.random.RandomState(seed)
    if method:
        raw = rng.randint(0, 256, (N, RAW_LEN, HW, HW, 3)).astype(np.uint8)
        return raw, np.array([RAW_LEN, 5, 3, 7, 6], np.int32)  # one shorter than T
    return (rng.rand(N, T, HW, HW, 3).astype(np.float32),)


def _classify(sv, method, arrays):
    return sv.classify_raw(*arrays) if method else sv.classify(*arrays)


@pytest.mark.parametrize("case", list(CASES), ids=IDS)
def test_artifact_matches_vcts_artifact(artifacts, case):
    vct_path, path = artifacts(case)
    method = case[1]
    arrays = _inputs(method)
    want = _classify(vct_aot.AotServable.load(vct_path), method, arrays)
    sv = aot.AotServable.load(path, device="cpu")
    got = _classify(sv, method, arrays)
    assert got.shape == (N, len(CLASSES)) and got.dtype == np.float32
    np.testing.assert_allclose(got.sum(-1), 1.0, rtol=1e-6)
    np.testing.assert_allclose(got, want, atol=1e-4)


@pytest.mark.parametrize("case", list(CASES), ids=IDS)
def test_artifact_matches_the_eager_forward(nets, artifacts, case):
    _, path = artifacts(case)
    name, method = case
    model = nets[name][2]
    arrays = _inputs(method, seed=1)
    sv = aot.AotServable.load(path, device="cpu")
    sv.warmup()
    got = _classify(sv, method, arrays)
    with torch.inference_mode():
        x = torch.from_numpy(arrays[0])
        if method:
            x = device_sample_clips(x, T, method=method, lengths=torch.from_numpy(arrays[1]))
        want = torch.softmax(model(x).float(), dim=-1).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.mark.parametrize("case", list(CASES), ids=IDS)
def test_exported_graph_holds_the_kernel_operators(artifacts, case):
    _, path = artifacts(case)
    sv = aot.AotServable.load(path, device="cpu")
    assert sv.buckets == BUCKETS
    for b in BUCKETS:
        ops = collections.Counter(
            str(n.target).split(".")[1] for n in sv._fns[b].graph.nodes
            if n.op == "call_function" and str(n.target).startswith("vct_torch."))
        assert dict(ops) == CASES[case]


def test_manifest_and_empty_input(artifacts):
    _, path = artifacts(("mamba", "sad"))
    with zipfile.ZipFile(path) as zf:
        manifest = json.loads(zf.read("manifest.json"))
        assert sorted(zf.namelist()) == ["batch_2.pt2", "batch_4.pt2", "manifest.json"]
    assert manifest == {
        "format": "vct-torch-aot-v1", "class_names": CLASSES, "input_shape": [T, HW, HW, 3],
        "batch_sizes": list(BUCKETS), "n_devices": 1, "sampling_method": None,
        "device_sampling": "sad", "raw_len": RAW_LEN, "platform": "cpu",
        "torch_version": torch.__version__}
    sv = aot.AotServable.load(path, device="cpu")
    empty = np.zeros((0, RAW_LEN, HW, HW, 3), np.uint8)
    assert sv.classify_raw(empty, np.zeros((0,), np.int32)).shape == (0, len(CLASSES))


def _rewrite_manifest(src, dst, **changes):
    with zipfile.ZipFile(src) as zin, zipfile.ZipFile(dst, "w") as zout:
        for item in zin.infolist():
            data = zin.read(item.filename)
            if item.filename == "manifest.json":
                data = json.dumps(json.loads(data) | changes).encode()
            zout.writestr(item, data)
    return str(dst)


@pytest.mark.parametrize("case", ["empty", "foreign_zip", "vct_format", "vct_caption_format",
                                  "caption_kind", "platform", "data_parallel", "directory"])
def test_load_refusals(artifacts, tmp_path, case):
    _, path = artifacts(("mamba", None))
    bad = tmp_path / "bad.vctaot"
    if case == "empty":
        bad.write_bytes(b"")
        match = "not a vct-torch-aot-v1 artifact"
    elif case == "foreign_zip":
        with zipfile.ZipFile(bad, "w") as zf:
            zf.writestr("model.pt", b"weights")
        match = "not a vct-torch-aot-v1 artifact"
    elif case in ("vct_format", "vct_caption_format"):
        fmt = "vct-aot-v1" if case == "vct_format" else "vct-aot-caption-v1"
        _rewrite_manifest(path, bad, format=fmt)
        match = r"convert_vct_checkpoint.py SRC DST.*python -m vct_torch.serve.aot"
    elif case == "caption_kind":
        _rewrite_manifest(path, bad, format="vct-torch-aot-caption-v1")
        match = "is a captioning artifact — load it with CaptionAotServable.load"
    elif case == "platform":
        _rewrite_manifest(path, bad, platform="cuda")
        match = "exported for platform='cuda' but the device here is 'cpu'"
    elif case == "data_parallel":
        _rewrite_manifest(path, bad, n_devices=2)
        with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 8"):
            aot.AotServable.load(str(bad), device="cpu")
        return
    else:
        bad = tmp_path
        match = "not a vct-torch-aot-v1 artifact"
    with pytest.raises(ValueError, match=match):
        aot.AotServable.load(str(bad), device="cpu")


def test_call_refusals(artifacts):
    dense = aot.AotServable.load(artifacts(("mamba", None))[1], device="cpu")
    raw = aot.AotServable.load(artifacts(("mamba", "sad"))[1], device="cpu")
    clips, = _inputs(None)
    frames, lens = _inputs("sad")
    with pytest.raises(ValueError, match="expected"):
        dense.classify(clips[:, :, :8])
    with pytest.raises(ValueError, match="feed raw clips via classify_raw"):
        raw.classify(clips)
    with pytest.raises(ValueError, match="no baked-in sampling"):
        dense.classify_raw(frames, lens)
    with pytest.raises(ValueError, match="uint8"):
        raw.classify_raw(frames.astype(np.float32), lens)
    with pytest.raises(ValueError, match="lengths must be"):
        raw.classify_raw(frames, lens[:3])
    for bad in (0, RAW_LEN + 1):
        with pytest.raises(ValueError, match=r"lengths must be in \[1, raw_len=8\]"):
            raw.classify_raw(frames, np.where(np.arange(N) == 2, bad, lens))


def test_export_refusals(nets, tmp_path):
    model = nets["mamba"][2]
    path = str(tmp_path / "m.vctaot")
    with pytest.raises(ValueError, match="raw_len only applies with device_sampling"):
        aot.export_servable(model, CLASSES, (T, HW, HW, 3), path, raw_len=8)
    with pytest.raises(ValueError, match="must exceed the sampled T"):
        aot.export_servable(model, CLASSES, (T, HW, HW, 3), path, device_sampling="sad",
                            raw_len=T)
    with pytest.raises(ValueError, match="batch sizes must be positive"):
        aot.export_servable(model, CLASSES, (T, HW, HW, 3), path, batch_sizes=(0, 2))
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 8"):
        aot.export_servable(model, CLASSES, (T, HW, HW, 3), path, data_parallel=2)
    assert not os.path.exists(path)


@pytest.mark.parametrize("name", ["pair_scores", "ssim_pair_scores", "selective_scan",
                                  "rnn_scan_lstm", "rnn_scan_gru", "rnn_stack_lstm",
                                  "rnn_stack_gru"])
def test_operators_pass_opcheck(name):
    import vct_torch.ops.lstm  # noqa: F401  (registers the operators)
    import vct_torch.ops.pair_scores  # noqa: F401
    import vct_torch.ops.selective_scan  # noqa: F401
    import vct_torch.ops.ssim  # noqa: F401

    rng = np.random.RandomState(0)

    def f32(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32))

    clips = torch.from_numpy(rng.randint(0, 256, (2, 5, 6, 7, 3)).astype(np.uint8))
    B, L, D, S, H = 2, 5, 4, 3, 4
    op, args = {
        "pair_scores": ("pair_scores", [(clips, "sad"), (clips, "flow")]),
        "ssim_pair_scores": ("ssim_pair_scores", [(clips, 3, 255.0)]),
        "selective_scan": ("selective_scan", [
            (f32(B, L, D), f32(B, L, D).abs(), -f32(D, S).abs(), f32(B, L, S), f32(B, L, S), r)
            for r in (False, True)]),
        "rnn_scan_lstm": ("rnn_scan", [(f32(B, L, 4 * H), f32(H, 4 * H), f32(4 * H), 4)]),
        "rnn_scan_gru": ("rnn_scan", [(f32(B, L, 3 * H), f32(H, 3 * H), f32(3 * H), 3)]),
        "rnn_stack_lstm": ("rnn_stack", [(f32(B, L, 4 * H), f32(2, H, 4 * H), f32(2, 4 * H),
                                          f32(1, H, 4 * H), f32(1, 4 * H), 4)]),
        "rnn_stack_gru": ("rnn_stack", [(f32(B, L, 3 * H), f32(2, H, 3 * H), f32(2, 3 * H),
                                         f32(1, H, 3 * H), f32(1, 3 * H), 3)]),
    }[name]
    for a in args:
        result = torch.library.opcheck(getattr(torch.ops.vct_torch, op).default, a)
        assert set(result.values()) == {"SUCCESS"}, result


def test_motion_dataset_matches_vcts(tmp_path):
    import cv2

    kw = dict(clips_per_class=(2, 1, 1, 1), frames=6, size=32, seed=3)
    want = vct_synthetic.generate_motion_dataset(str(tmp_path / "vct"), **kw)
    got = synthetic.generate_motion_dataset(str(tmp_path / "port"), **kw)
    assert got == want == sorted(synthetic.MOTION_CLASSES)
    for cls, n in zip(synthetic.MOTION_CLASSES, kw["clips_per_class"]):
        for i in range(n):
            frames = []
            for root in ("vct", "port"):
                cap = cv2.VideoCapture(str(tmp_path / root / cls / f"clip_{i:03d}.mp4"))
                fr = []
                ok, f = cap.read()
                while ok:
                    fr.append(f)
                    ok, f = cap.read()
                cap.release()
                frames.append(np.stack(fr))
            assert len(frames[0]) == kw["frames"]
            np.testing.assert_array_equal(frames[0], frames[1])
