"""``vct_torch.parallel`` and the serving paths across devices, in one
process on the CPU (``[cpu, cpu]`` device meshes stand in for two cards):

- the sharding rule against ``vct.parallel.shard.param_pspec`` on the bridged
  leaves of the deployed Mamba LRCN, an LSTM LRCN and VideoMamba at model = 2
  and 4 (the same parameters shard, along the torch dim that carries the
  leaf's last one), and ``tests/test_shard_rules.py``'s anchored, look-alike
  and backbone cases;
- ``process_shard`` equal to ``vct``'s over a grid; ``make_mesh``'s errors
  equal to ``vct``'s, and its refusal to span the CPU unasked when there is
  no card; the mesh carrier's nesting;
- ``classify_videos`` over ``[cpu, cpu]`` (and a (2, 2) grid) against the
  port's one-device path, and against ``vct``'s (4, 2) mesh result (run in a
  process of its own on a virtual 8-device CPU mesh), within 1e-5;
- a ``data_parallel=2`` artifact served over two CPU devices, dense and raw,
  within 1e-5 of the eager one-device forward, its replicas all started
  before any output is copied back;
- the worker with ``VCT_WORKER_MESH=1`` over two devices, its stored scores
  within 1e-5 of the one-device worker's.
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from test_torch_train import _random_variables
from vct.core import config as vct_config
from vct.models import build_model as vct_build_model
from vct.parallel import mesh as vct_mesh
from vct.parallel import multihost as vct_multihost
from vct.parallel import shard as vct_shard
from vct_torch.bridge import _sources, load_vct_variables
from vct_torch.core import config
from vct_torch.core.config import ServeConfig
from vct_torch.models import build_model
from vct_torch.parallel import mesh, multihost, shard
from vct_torch.serve import aot, deployment, worker
from vct_torch.train.checkpoint import save_checkpoint

REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
TOL = 1e-5  # serving across replicas (tests/test_serve.py, tests/test_aot.py)
CLASSES = [f"class_{i}" for i in range(4)]
T, HW = 3, 32
SERVED = {"model.cnn_backbone": "resnet18", "model.rnn_type": "mamba",
          "model.rnn_input_size": "8", "model.rnn_layer": "2", "data.sequence_length": str(T),
          "data.img_height": str(HW), "data.img_width": str(HW), "model.scan_impl": "pallas"}
MODELS = {
    "deployed_mamba": {"model.cnn_backbone": "resnet18", "model.rnn_type": "mamba",
                       "model.rnn_input_size": "8", "model.rnn_layer": "3"},
    "lstm": {"model.cnn_backbone": "resnet18", "model.rnn_type": "lstm",
             "model.rnn_input_size": "16", "model.hidden_size": "12", "model.rnn_layer": "2"},
    "videomamba": {"model.cnn_backbone": "resnet18", "model.model_family": "videomamba",
                   "model.vm_n_layer": "2", "model.vm_d_model": "32", "model.vm_d_inner": "64",
                   "model.vm_n_state": "16", "model.vm_dt_rank": "16"},
}


def _vct_specs(params, model_size):
    """{leaf path: sharded} of vct's rule."""
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    out = {}
    for path, leaf in flat:
        spec = vct_shard.param_pspec(path, leaf, model_size)
        out["/".join(str(getattr(k, "key", k)) for k in path)] = spec != vct_shard.P()
    return out


@pytest.mark.parametrize("model_size", [2, 4])
@pytest.mark.parametrize("family", sorted(MODELS))
def test_sharding_rule_matches_vcts_on_bridged_leaves(family, model_size):
    overrides = {**MODELS[family], "data.sequence_length": "4"}
    vct_model = vct_build_model(vct_config.Config().replace(**overrides).model, 4)
    shapes = jax.eval_shape(vct_model.init, jax.random.PRNGKey(0),
                            jax.numpy.zeros((1, 4, 32, 32, 3)))
    want = _vct_specs(shapes["params"], model_size)
    port = build_model(config.Config().replace(**overrides).model, 4, device="cpu")
    specs = shard.param_specs(port, model_size)
    params = dict(port.named_parameters())
    seen = {}
    for mname, mod in port.named_modules():
        for tname, path, _ in _sources(mod, mname):
            name = f"{mname}.{tname}" if mname else tname
            if name not in params:
                continue
            leaf = path.split("/", 1)[1]
            seen[leaf] = name in specs
            if name in specs:
                assert shard.param_pspec(name, params[name], model_size, port) == specs[name]
                # the sharded torch dim carries the leaf's last one
                assert params[name].shape[specs[name]] == \
                    _leaf(shapes["params"], leaf).shape[-1]
    assert seen == want
    assert any(seen.values()) and not any(v for k, v in seen.items()
                                          if k.startswith("cnn_backbone/"))


def _leaf(tree, path):
    for key in path.split("/"):
        tree = tree[key]
    return tree


SEGMENTS = [
    ["adapt", "adapt1", "kernel"], ["head", "fc", "kernel"], ["rnn", "lstm", "weight_ih_l0"],
    ["mamba_0", "mixer", "in_proj", "kernel"], ["layer_3", "mixer", "in_proj", "kernel"],
    ["classifier", "kernel"], ["overhead", "kernel"], ["adaptive_pool", "kernel"],
    ["cnn_backbone", "layer1_0", "conv1", "kernel"], ["layer1_0", "conv1", "kernel"],
    ["mamba_x", "kernel"], ["cnn_backbone", "head", "conv", "kernel"], ["cnn", "fc", "kernel"],
]


@pytest.mark.parametrize("segments", SEGMENTS, ids=["/".join(s) for s in SEGMENTS])
def test_anchored_lookalike_and_backbone_segments_as_vct(segments):
    assert shard._is_tp_path(segments) == vct_shard._is_tp_path(segments)


def test_process_shard_matches_vct_over_a_grid():
    for n in range(0, 23):
        for count in range(1, 7):
            for index in range(count):
                np.testing.assert_array_equal(multihost.process_shard(n, index, count),
                                              vct_multihost.process_shard(n, index, count))
    assert multihost.is_primary() and multihost.process_count() == 1


@pytest.mark.parametrize("n,data,model", [(3, -1, 2), (4, 3, 1), (4, 2, 3), (2, 1, 1)])
def test_make_mesh_errors_match_vct(n, data, model):
    with pytest.raises(ValueError) as want:
        vct_mesh.make_mesh([object()] * n, data=data, model=model)
    with pytest.raises(ValueError) as got:
        mesh.make_mesh([CPU] * n, data=data, model=model)
    assert str(got.value) == str(want.value)


def test_make_mesh_without_a_card_raises(monkeypatch):
    """With no devices named and no process group, the mesh spans the
    cards: without CUDA it raises as every entry point does, and never
    spans the CPU unasked."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mesh.make_mesh()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mesh.make_mesh(model=1)


def test_make_mesh_shapes_and_the_carrier_nests():
    m = mesh.make_mesh([CPU] * 4, model=2)
    assert m.shape == {"data": 2, "model": 2} and m.size == 4 and not m.distributed
    assert m.axis_names == ("data", "model")
    assert mesh.ambient_mesh() is None
    outer = mesh.make_mesh([CPU] * 2, data=2, model=1)
    with mesh.activate_mesh(outer) as got:
        assert mesh.ambient_mesh() is got is outer
        inner = mesh.make_mesh([CPU] * 2, data=1, model=2)
        with mesh.activate_mesh(inner):
            assert mesh.ambient_mesh() is inner
        assert mesh.ambient_mesh() is outer
    assert mesh.ambient_mesh() is None


def test_training_over_devices_of_one_process_is_refused():
    """Training across devices is one process a rank: a device mesh of more
    than one device is refused, one of one device trains as before."""
    from vct_torch.train.engine import Trainer

    cfg = config.Config().replace(**SERVED)
    with pytest.raises(ValueError, match="one process a rank"):
        Trainer(cfg, CLASSES, mesh=mesh.make_mesh([CPU, CPU]))
    trainer = Trainer(cfg, CLASSES, mesh=mesh.make_mesh([CPU]))
    assert trainer.device == CPU and not trainer.mesh.distributed


def test_batch_placement_on_a_device_mesh():
    m = mesh.make_mesh([CPU] * 4, data=2, model=2)
    x = np.arange(12, dtype=np.float32).reshape(6, 2)
    parts = mesh.put_sharded(x, mesh.batch_sharding(m))
    assert [p.tolist() for p in parts] == [x[:3].tolist(), x[3:].tolist()]
    xs, ys = mesh.shard_batch((x, x[:, 0]), m)
    assert len(xs) == len(ys) == 2
    assert len(mesh.put_sharded(x, mesh.replicated(m))) == 2
    with pytest.raises(ValueError, match="does not split over data=2"):
        mesh.put_sharded(x[:5], mesh.batch_sharding(m))


# ---------------------------------------------------------------------------
# serving across replicas


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """A seeded LRCN with K3's operator in both packages, its clips, the
    port's probabilities on one device and vct's over a (4, 2) mesh."""
    root = tmp_path_factory.mktemp("parallel")
    vct_model = vct_build_model(vct_config.Config().replace(**SERVED).model, T)
    rng = np.random.RandomState(5)
    clips = rng.rand(11, T, HW, HW, 3).astype(np.float32)
    variables = _random_variables(vct_model, clips[:1], seed=7)
    with open(root / "vct_classify.pkl", "wb") as f:
        pickle.dump({"overrides": SERVED, "variables": variables, "clips": clips,
                     "batch_size": 4}, f)
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": str(REPO),
           "XLA_FLAGS": "--xla_force_host_platform_device_count=8"}
    proc = subprocess.Popen([sys.executable, str(REPO / "tests" / "vct_multirank_child.py"),
                             str(root), "classify"], env=env, cwd=str(REPO),
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        cfg = config.Config().replace(**SERVED)
        model = build_model(cfg.model, T, device="cpu")
        load_vct_variables(model, variables)
        one = deployment.classify_videos(model, clips, batch_size=4, device="cpu")
        log, _ = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, log[-3000:]
    with open(root / "vct_probs.pkl", "rb") as f:
        vct_probs = pickle.load(f)
    return {"root": root, "cfg": cfg, "model": model, "clips": clips, "one": one,
            "vct": vct_probs}


@pytest.mark.parametrize("data,model,batch", [(2, 1, 4), (2, 2, 4), (2, 1, 5)])
def test_classify_videos_over_replicas(served, data, model, batch):
    m = mesh.make_mesh([CPU] * (data * model), data=data, model=model)
    got = deployment.classify_videos(served["model"], served["clips"], batch_size=batch,
                                     mesh=m)
    assert got.shape == (11, 4)
    np.testing.assert_allclose(got, served["one"], atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got, served["vct"], atol=TOL, rtol=TOL)
    replicas = deployment.mesh_replicas(served["model"], m)
    assert len(replicas) == data and replicas[0] is served["model"]
    assert replicas[1] is not served["model"]


def test_classify_videos_refuses_a_rank_mesh(served):
    class RankMesh:
        distributed = True

    with pytest.raises(ValueError, match="serving spans the cards of one process"):
        deployment.classify_videos(served["model"], served["clips"], mesh=RankMesh())


@pytest.mark.parametrize("sampling", [None, "sad"], ids=["dense", "raw"])
def test_data_parallel_artifact_over_two_devices(served, sampling):
    """Each replica's program runs 2 of a bucket's 4 rows; the joined rows
    against the eager one-device forward (with the same on-device SAD
    selection for raw clips)."""
    from vct_torch.data.preprocess import device_sample_clips

    model, path = served["model"], served["root"] / f"two_{sampling}.vctaot"
    aot.export_servable(model, CLASSES, (T, HW, HW, 3), str(path), batch_sizes=(4,),
                        data_parallel=2, devices=[CPU, CPU], device_sampling=sampling,
                        raw_len=2 * T if sampling else None)
    two = aot.AotServable.load(str(path), device="cpu", devices=["cpu", "cpu"])
    assert two.n_devices == 2 and two.devices == [CPU, CPU]
    with pytest.raises(ValueError, match="exported for 2 devices; only 1 are visible"):
        aot.AotServable.load(str(path), device="cpu")
    if sampling is None:
        got, want = two.classify(served["clips"]), served["one"]
    else:
        rng = np.random.RandomState(9)
        raw = rng.randint(0, 256, (7, 2 * T, HW, HW, 3)).astype(np.uint8)
        lengths = rng.randint(1, 2 * T + 1, 7).astype(np.int32)
        got = two.classify_raw(raw, lengths)
        with torch.inference_mode():
            clips = device_sample_clips(torch.from_numpy(raw), T, method="sad",
                                        lengths=torch.from_numpy(lengths))
            want = torch.softmax(model(clips), dim=-1).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_replicas_start_every_program_before_copying_back():
    """A data-parallel bucket starts each replica's program before it copies
    any output to the host (a copy waits for its card), and joins the
    outputs in row order."""
    log = []

    class Out:
        def __init__(self, i, value):
            self.i, self.value = i, value

        def cpu(self):
            log.append(f"copy {self.i}")
            return self.value

    def replica(i):
        def run(x):
            log.append(f"run {i}")
            return (Out(i, x * 2), Out(i, x + 1))
        return run

    fn = aot._Replicas([replica(0), replica(1)], [CPU, CPU])
    doubled, plus = fn(np.arange(4, dtype=np.float32))
    assert log[:2] == ["run 0", "run 1"] and sorted(log[2:]) == ["copy 0"] * 2 + ["copy 1"] * 2
    assert doubled.tolist() == [0, 2, 4, 6] and plus.tolist() == [1, 2, 3, 4]


def test_worker_serves_across_devices(served, tmp_path, monkeypatch):
    ck = save_checkpoint(str(tmp_path / "ck"), served["model"].state_dict(), served["cfg"],
                         CLASSES)
    names = [f"@u_video_{i}.mp4" for i in range(len(served["clips"]))]
    monkeypatch.setattr(worker, "load_dataset_inference",
                        lambda *a, **k: (served["clips"], names))
    posted = []
    monkeypatch.setattr(worker, "post_results",
                        lambda results, url: posted.append(results) or {})
    cfg = ServeConfig(model_path=ck, video_dir=str(tmp_path / "videos"))
    scores = {}
    for devices in ([CPU, CPU], [CPU]):
        monkeypatch.setenv("VCT_WORKER_MESH", "1")
        monkeypatch.setattr(deployment, "visible_devices", lambda dev, d=devices: d)
        w = worker.Worker(cfg, downloader=lambda url, save_dir: None, device="cpu")
        try:
            monkeypatch.setattr(w, "_already_classified", lambda: [])
            w.callback("https://www.tiktok.com/@u/video/0")
        finally:
            w.pull.close()
        assert (w.mesh is None) == (len(devices) == 1)
        scores[len(devices)] = {r["video_name"]: dict(zip(r["labels"], r["scores"]))
                                for r in posted[-1]}
    assert scores[1].keys() == scores[2].keys() == set(names)
    for name in names:
        for label, score in scores[1][name].items():
            assert abs(scores[2][name][label] - score) <= TOL
