"""vct_torch's AOT artifacts served through the CLIs and the worker, against
vct's, on the CPU.

One Mamba LRCN's seeded weights (a vct variables tree, carried into the port
by the bridge): vct's artifact of them and the port's, exported by ``python
-m vct_torch.serve.aot`` from a vct_torch checkpoint, give the same labels
and scores within 1e-4 through ``deployment.main --model FILE`` (``--videos``
and ``--frames``) and through the queue worker with MODEL_PATH a file; a raw
(``device_sampling``) artifact is refused by both; the export CLI prints
vct's line and keeps its errors; and a fresh interpreter that loads and
calls the artifact imports no model zoo, config, host preprocessing or
trainer.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from test_torch_data import write_video
from vct.core import config as vct_config
from vct.data import ingest as vct_ingest
from vct.data.video import ParallelDecoder as VctParallelDecoder
from vct.models import build_model as vct_build_model
from vct.serve import aot as vct_aot
from vct.serve import deployment as vct_deployment
from vct.serve import worker as vct_worker
from vct_torch.bridge import load_vct_variables
from vct_torch.core import config
from vct_torch.data import ingest
from vct_torch.data.video import ParallelDecoder
from vct_torch.models import build_model
from vct_torch.serve import aot, deployment, worker
from vct_torch.train.checkpoint import save_checkpoint

cv2 = pytest.importorskip("cv2")
T, HW = 4, 16
BUCKETS = (2, 4)
CLASSES = ["calm", "fight", "other"]
# The export CLI, the deployment CLI and the worker, each against vct's on
# an artifact of the same weights.
OVERRIDES = {"model.num_classes": "3", "model.cnn_backbone": "resnet18",
             "model.rnn_type": "mamba", "model.rnn_input_size": "8", "model.rnn_layer": "2",
             "model.scan_impl": "pallas", "data.sequence_length": str(T),
             "data.img_height": str(HW), "data.img_width": str(HW),
             "data.sampling_method": "sad"}
LENGTHS = (3, 9, 13)
NAMES = [f"@user{i}_video_{100 + i}.mp4" for i in range(len(LENGTHS))]


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """(vct's artifact, the port's checkpoint, the port's artifact from the
    CLI and its printed line, the videos, the port's raw artifact) of one
    set of seeded Mamba weights."""
    root = tmp_path_factory.mktemp("served")
    cfg_v = vct_config.Config().replace(**OVERRIDES)
    flax_model = vct_build_model(cfg_v.model, T)
    x0 = jnp.zeros((1, T, HW, HW, 3), jnp.float32)
    variables = jax.tree_util.tree_map(np.asarray, flax_model.init(jax.random.PRNGKey(1), x0))
    model = build_model(config.Config().replace(**OVERRIDES).model, T, device="cpu")
    load_vct_variables(model, variables)
    vct_art = str(root / "vct.vctaot")
    # vct's side in one bucket: its export and compile dominate the file.
    vct_aot.export_servable(flax_model, variables, CLASSES, (T, HW, HW, 3), vct_art,
                            batch_sizes=BUCKETS[-1:], sampling_method="sad")
    ck = str(root / "ck")
    save_checkpoint(ck, model.state_dict(), config.Config().replace(**OVERRIDES), CLASSES)
    art = str(root / "port.vctaot")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = aot.main(["--model", ck, "--out", art, "--batches", "2,4", "--device", "cpu"])
    assert rc == 0
    rng = np.random.RandomState(0)
    videos = root / "videos"
    videos.mkdir()
    for name, n in zip(NAMES, LENGTHS):
        write_video(videos / name, rng.randint(0, 256, (n, 30, 34, 3), np.uint8))
    return vct_art, ck, art, out.getvalue(), str(videos)


def test_export_cli(served, tmp_path, capsys):
    _, ck, art, printed, _ = served
    assert printed.strip() == (f"exported {art}: platform=cpu buckets=[2, 4] devices=1 "
                               f"classes={CLASSES}")
    sv = aot.AotServable.load(art, device="cpu")
    assert sv.sampling_method == "sad" and sv.input_shape == (T, HW, HW, 3)
    raw = str(tmp_path / "raw.vctaot")
    assert aot.main(["--model", ck, "--out", raw, "--device_sampling", "sad", "--raw_len", "8",
                     "--batches", "2", "--device", "cpu"]) == 0
    assert capsys.readouterr().out.strip() == (
        f"exported {raw}: platform=cpu buckets=[2] devices=1 device_sampling=sad raw_len=8 "
        f"classes={CLASSES}")
    for argv, said in ((["--beam_width", "3"], "--beam_width applies to caption checkpoints"),
                       (["--height", "8"], "--height applies to caption checkpoints"),
                       (["--raw_len", "8"], "--raw_len requires --device_sampling")):
        with pytest.raises(SystemExit):
            aot.main(["--model", ck, "--out", raw, "--device", "cpu", *argv])
        assert said in capsys.readouterr().err
    # One CPU device: data_parallel=2 is refused as vct refuses more than its devices.
    with pytest.raises(ValueError, match="data_parallel=2 but only 1 devices are visible"):
        aot.main(["--model", ck, "--out", raw, "--data_parallel", "2", "--device", "cpu"])


def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue()


def _results(out):
    lines = out.splitlines()
    start = lines.index("[")
    return json.loads("\n".join(lines[start:lines.index("]", start) + 1]))


def _one_process_decode(monkeypatch):
    # vct decodes in one process (its pool forks, unsafe under JAX's
    # threads); the port's pool spawns two workers.
    monkeypatch.setattr(vct_ingest, "ParallelDecoder",
                        lambda workers=4, decoder="cv2": VctParallelDecoder(1, decoder))
    monkeypatch.setattr(ingest, "ParallelDecoder",
                        lambda workers=4, decoder="cv2": ParallelDecoder(2, decoder))


def _hold(got, want):
    assert [r["video_name"] for r in got] == [r["video_name"] for r in want]
    for g, w in zip(got, want):
        assert g["labels"] == w["labels"]
        np.testing.assert_allclose(g["scores"], w["scores"], atol=1e-4)


def test_deployment_cli_serves_an_artifact_as_vcts_does(served, monkeypatch):
    vct_art, _, art, _, videos = served[:5]
    _one_process_decode(monkeypatch)
    rc_v, out_v = _run(vct_deployment.main, ["--model", vct_art, "--videos", videos,
                                             "--sequence_length", "7", "--mesh"])
    rc_t, out_t = _run(deployment.main, ["--model", art, "--videos", videos,
                                         "--sequence_length", "7", "--mesh", "--device", "cpu"])
    assert rc_v == rc_t == 0
    _hold(_results(out_t), _results(out_v))
    for out in (out_v, out_t):
        assert f"--sequence_length 7 overridden to {T}" in out
        assert "--mesh is ignored for .vctaot artifacts" in out
    assert "export with --data_parallel" in out_t
    frames = os.path.join(os.path.dirname(videos), "frames")
    os.makedirs(frames)
    import cv2

    rng = np.random.RandomState(3)
    for i in range(6):
        cv2.imwrite(os.path.join(frames, f"f_{i}.png"), rng.randint(0, 256, (30, 34, 3),
                                                                    np.uint8))
    rc_v, out_v = _run(vct_deployment.main, ["--model", vct_art, "--frames", frames])
    rc_t, out_t = _run(deployment.main, ["--model", art, "--frames", frames, "--device", "cpu"])
    assert rc_v == rc_t == 0
    assert out_t.splitlines()[-1] == out_v.splitlines()[-1]
    assert out_t.splitlines()[-1].startswith("Predicted class: ")


def test_worker_serves_an_artifact_as_vcts_does(served, tmp_path, monkeypatch):
    vct_art, _, art, _, videos = served[:5]
    _one_process_decode(monkeypatch)
    posted = {}

    def recorder(name):
        def post_results(results, url):
            posted[name] = results
            return {r["video_name"]: True for r in results}

        return post_results

    for name, module in (("vct", vct_worker), ("port", worker)):
        monkeypatch.setattr(module, "post_results", recorder(name))
    monkeypatch.delenv("SAMPLING_METHOD", raising=False)
    kw = dict(sampling_method="uniform", sequence_length=60, queue_port=0)
    cfg_v = vct_config.ServeConfig(model_path=vct_art, video_dir=str(tmp_path / "v"), **kw)
    cfg_t = config.ServeConfig(model_path=art, video_dir=str(tmp_path / "t"), **kw)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        w_v = vct_worker.Worker(cfg_v)
        w_t = worker.Worker(cfg_t, device="cpu")
    # The artifact's T and its recorded sampling override the environment's defaults.
    assert out.getvalue().count(f"SEQUENCE_LENGTH=60 overridden to {T}") == 2
    for w in (w_v, w_t):
        assert w.cfg.sequence_length == T and w.cfg.sampling_method == "sad"
        w._already_classified = lambda: []
        w.downloader = lambda url, save_dir: [shutil.copy(os.path.join(videos, n), save_dir)
                                              for n in NAMES]
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            w_v.callback("https://www.tiktok.com/@user0/video/100")
            w_t.callback("https://www.tiktok.com/@user0/video/100")
    finally:
        w_v.pull.close()
        w_t.pull.close()
    _hold(posted["port"], posted["vct"])
    assert sorted(r["video_name"] for r in posted["port"]) == sorted(NAMES)


def test_cli_and_worker_refuse_a_raw_artifact(tmp_path, served):
    path = str(tmp_path / "raw.vctaot")
    assert aot.main(["--model", served[1], "--out", path, "--device_sampling", "sad",
                     "--batches", "2", "--device", "cpu"]) == 0
    with pytest.raises(SystemExit):
        deployment.main(["--model", path, "--videos", served[4], "--device", "cpu"])
    cfg = config.ServeConfig(model_path=path, video_dir=str(tmp_path / "v"), queue_port=0)
    with pytest.raises(ValueError, match="export without --device_sampling"):
        worker.Worker(cfg, device="cpu")


def test_serving_an_artifact_imports_no_model_zoo(served):
    """A fresh interpreter loads and calls a classifier artifact: the model
    zoo, the config, the host preprocessing and the trainer stay unimported."""
    art = served[2]
    code = ("import json, sys\n"
            "import numpy as np\n"
            "from vct_torch.serve.aot import AotServable\n"
            f"sv = AotServable.load({art!r}, device='cpu')\n"
            "p = sv.classify(np.zeros((1,) + sv.input_shape, np.float32))\n"
            "assert p.shape == (1, 3)\n"
            "print(json.dumps(sorted(sys.modules)))\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=root, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    modules = json.loads(out.stdout.strip().splitlines()[-1])
    assert "vct_torch.serve.aot" in modules and "vct_torch.ops.selective_scan" in modules
    zoo = ("vct_torch.models", "vct_torch.core.config", "vct_torch.data.preprocess",
           "vct_torch.train")
    assert [m for m in modules if m.startswith(zoo)] == []
    assert not any(m == "vct" or m.startswith("vct.") or m.startswith("jax") for m in modules)


