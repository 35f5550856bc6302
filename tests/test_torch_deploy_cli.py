"""``python -m vct_torch.serve.deployment`` against ``vct``'s ``main`` on the
same weights, on the CPU: a directory of mp4 files (written here with cv2)
classified with host sampling, with ``--device_sampling`` (sad and ssim), a
frame directory, and ``--post`` to a local HTTP server; ``post_results``
against ``vct``'s; the refusals.

One seeded set of variables (``test_torch_train._random_variables``) is
saved as a ``vct`` checkpoint and, through the bridge, as a ``vct_torch``
one. Labels must be equal and probabilities within 1e-4.
"""

from __future__ import annotations

import contextlib
import io
import json
import threading
import zipfile
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest
import torch

from test_torch_data import write_video
from test_torch_train import _random_variables
from vct.core import config as vct_config
from vct.data import ingest as vct_ingest
from vct.data.video import ParallelDecoder as VctParallelDecoder
from vct.models import build_model as vct_build_model
from vct.serve import deployment as vct_deployment
from vct.train.checkpoint import save_checkpoint as vct_save_checkpoint
from vct_torch.bridge import load_vct_variables
from vct_torch.core import config
from vct_torch.models import build_model
from vct_torch.serve import deployment
from vct_torch.train.checkpoint import save_checkpoint

cv2 = pytest.importorskip("cv2")
T, HW = 4, 24
CLASSES = ["calm", "fight", "other"]
OVERRIDES = {"model.num_classes": "3", "model.cnn_backbone": "resnet18",
             "model.rnn_type": "mamba", "model.rnn_input_size": "8", "model.rnn_layer": "2",
             "model.scan_impl": "pallas", "data.sequence_length": str(T),
             "data.img_height": str(HW), "data.img_width": str(HW),
             "data.sampling_method": "uniform"}


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """(vct checkpoint, vct_torch checkpoint, videos dir, frames dir)."""
    root = tmp_path_factory.mktemp("serve")
    cfg_v = vct_config.Config().replace(**OVERRIDES)
    cfg_t = config.Config().replace(**OVERRIDES)
    flax_model = vct_build_model(cfg_v.model, T)
    variables = _random_variables(flax_model, np.zeros((1, T, HW, HW, 3), np.float32))
    vct_save_checkpoint(str(root / "ck_vct"), variables, cfg_v, CLASSES)
    model = build_model(cfg_t.model, T, device="cpu")
    load_vct_variables(model, variables)
    save_checkpoint(str(root / "ck_port"), model.state_dict(), cfg_t, CLASSES)
    rng = np.random.RandomState(0)
    videos = root / "videos"
    videos.mkdir()
    for i, n in enumerate((3, 9, 13, 20)):  # one shorter than T, the rest longer
        write_video(videos / f"@user{i}_video_{100 + i}.mp4",
                    rng.randint(0, 256, (n, 30, 34, 3), np.uint8))
    (videos / "broken.mp4").write_bytes(b"not a video")
    (videos / "notes.txt").write_text("not a video name")
    frames = root / "frames"
    frames.mkdir()
    for i in range(6):
        cv2.imwrite(str(frames / f"f_{i}.png"), rng.randint(0, 256, (30, 34, 3), np.uint8))
    return str(root / "ck_vct"), str(root / "ck_port"), str(videos), str(frames)


def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue()


def _results(out):
    """The JSON list ``classify_and_display`` prints."""
    lines = out.splitlines()
    start = lines.index("[")
    end = lines.index("]", start)
    return json.loads("\n".join(lines[start:end + 1]))


@contextlib.contextmanager
def _backend(statuses):
    """A local HTTP server that records each POSTed JSON body and answers
    with the next of ``statuses``."""
    bodies, replies = [], list(statuses)

    class Handler(BaseHTTPRequestHandler):
        def do_POST(self):
            bodies.append(json.loads(self.rfile.read(int(self.headers["Content-Length"]))))
            status = replies.pop(0) if replies else 200
            self.send_response(status)
            self.end_headers()
            self.wfile.write(b"ok" if status < 300 else b"backend says no")

        def log_message(self, *args):
            pass

    server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        yield f"http://127.0.0.1:{server.server_address[1]}/classify", bodies
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
        assert not thread.is_alive()


@pytest.mark.parametrize("mode", ["host_sad", "device_sad", "device_ssim_post"])
def test_cli_classifies_a_video_directory_as_vct(served, mode, monkeypatch):
    ck_vct, ck_port, videos, _ = served
    # vct decodes in one process: its pool forks, unsafe under JAX's threads.
    monkeypatch.setattr(vct_ingest, "ParallelDecoder",
                        lambda workers=4, decoder="cv2": VctParallelDecoder(1, decoder))
    args = ["--videos", videos, "--batch_size", "3"]
    if mode == "host_sad":
        args += ["--sampling", "sad", "--mesh"]
    else:
        args += ["--device_sampling", "--sampling", mode.split("_")[1]]
    if mode.endswith("post"):
        with _backend([200, 201, 500, 200]) as (url, want_bodies):
            rc_v, out_v = _run(vct_deployment.main, ["--model", ck_vct, *args, "--post",
                                                     "--backend_url", url])
        with _backend([200, 201, 500, 200]) as (url, got_bodies):
            rc_t, out_t = _run(deployment.main, ["--model", ck_port, *args, "--post",
                                                 "--backend_url", url, "--device", "cpu"])
        assert len(got_bodies) == len(want_bodies) == 4
        for got, want in zip(got_bodies, want_bodies):
            assert (got["url"], got["labels"]) == (want["url"], want["labels"])
            np.testing.assert_allclose(got["scores"], want["scores"], atol=1e-4)
        said = ("Successfully sent", "Failed to send", "Error sending")
        posted = [l for l in out_t.splitlines() if l.startswith(said)]
        assert posted == [l for l in out_v.splitlines() if l.startswith(said)]
        assert sum("Successfully sent" in l for l in posted) == 3
    else:
        rc_v, out_v = _run(vct_deployment.main, ["--model", ck_vct, *args])
        rc_t, out_t = _run(deployment.main, ["--model", ck_port, *args, "--device", "cpu"])
    assert rc_v == rc_t == 0
    got, want = _results(out_t), _results(out_v)
    assert [r["video_name"] for r in got] == [r["video_name"] for r in want] == [
        f"@user{i}_video_{100 + i}.mp4" for i in range(4)]
    for g, w in zip(got, want):
        assert g["labels"] == w["labels"]
        np.testing.assert_allclose(g["scores"], w["scores"], atol=1e-4)
    keep = ("Final data shape", "Processed ", "Error processing")
    assert [l for l in out_t.splitlines() if l.startswith(keep)] == \
        [l for l in out_v.splitlines() if l.startswith(keep)]
    assert out_t.split("Label Counts:")[1] == out_v.split("Label Counts:")[1]


def test_cli_classifies_a_frame_directory_as_vct(served):
    ck_vct, ck_port, _, frames = served
    rc_v, out_v = _run(vct_deployment.main, ["--model", ck_vct, "--frames", frames])
    rc_t, out_t = _run(deployment.main, ["--model", ck_port, "--frames", frames,
                                         "--device", "cpu"])
    assert rc_v == rc_t == 0
    assert out_t.strip().splitlines()[-1] == out_v.strip().splitlines()[-1]
    assert out_t.strip().splitlines()[-1].startswith("Predicted class: ")


def test_post_results_reports_what_the_backend_confirmed(capsys):
    results = [{"video_name": n, "labels": ["a", "b"], "scores": [0.75, 0.25],
                "timestamp": "2026-01-01T00:00:00"}
               for n in ("@a_video_1.mp4", "no_url.mp4", "@b_video_2.mp4", "@c_video_3.mp4")]
    outs = []
    for post in (vct_deployment.post_results, deployment.post_results):
        with _backend([201, 404, 200]) as (url, bodies):
            outs.append((post(results, url), bodies, capsys.readouterr().out))
    (want, want_bodies, want_out), (got, got_bodies, got_out) = outs
    assert got == want == {"@a_video_1.mp4": True, "no_url.mp4": False,
                           "@b_video_2.mp4": False, "@c_video_3.mp4": True}
    assert got_bodies == want_bodies and got_out == want_out
    assert "HTTP 404: backend says no" in got_out
    with _backend([]) as (url, _):
        closed = url  # the server is shut down when the block ends
    got = deployment.post_results(results[:1], closed)
    assert got == {"@a_video_1.mp4": False}
    assert "Error sending result to backend for @a_video_1.mp4" in capsys.readouterr().out


def test_cli_refusals(served, tmp_path, monkeypatch):
    _, ck_port, videos, _ = served
    artifact = tmp_path / "m.vctaot"
    artifact.write_bytes(b"")
    with pytest.raises(ValueError, match="not a vct-torch-aot-v1 artifact"):
        deployment.main(["--model", str(artifact), "--videos", videos, "--device", "cpu"])
    with pytest.raises(SystemExit):
        deployment.main(["--model", ck_port, "--device", "cpu"])
    monkeypatch.setattr(deployment, "_visible_devices", lambda dev: 2)
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 8"):
        deployment.main(["--model", ck_port, "--videos", videos, "--mesh", "--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        deployment.main(["--model", ck_port, "--videos", videos])
    empty = tmp_path / "empty"
    empty.mkdir()
    rc, out = _run(deployment.main, ["--model", ck_port, "--videos", str(empty),
                                     "--device", "cpu", "--device_sampling"])
    assert rc == 1 and "No videos found." in out


def test_vct_artifact_refusal_names_the_converter(served, tmp_path):
    artifact = tmp_path / "m.vctaot"
    with zipfile.ZipFile(artifact, "w") as zf:
        zf.writestr("manifest.json", json.dumps({"format": "vct-aot-v1", "platform": "cpu"}))
    with pytest.raises(ValueError, match="convert_vct_checkpoint.py SRC DST"):
        deployment.main(["--model", str(artifact), "--videos", served[2], "--device", "cpu"])
