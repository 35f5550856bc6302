"""``vct_torch.serve.worker`` against ``vct``'s worker on the CPU, the whole
serving loop (backend, queue, worker, store) of the port, and the repair of
``classify_videos`` / ``_load_with_device_sampling`` that keeps a request's
clips off the device but for one batch.

One seeded set of variables (``test_torch_train._random_variables``) is
saved as a ``vct`` checkpoint and, through the bridge, as a ``vct_torch``
one. The videos are small mp4 files written with cv2 under the names the
TikTok client gives (``@user_video_<id>.mp4``). Each worker gets a
``downloader`` that copies the message's file into its ``VIDEO_DIR`` and a
local backend with its own store. Labels must be equal, scores within 1e-4,
and the files kept and the store's rows the same.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import re
import shutil
import socket
import threading
import zipfile
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import requests
import torch

from test_torch_data import write_video
from test_torch_train import _random_variables
from vct.core import config as vct_config
from vct.data import ingest as vct_ingest
from vct.data.video import ParallelDecoder as VctParallelDecoder
from vct.models import build_model as vct_build_model
from vct.serve import deployment as vct_deployment
from vct.serve import worker as vct_worker
from vct.train.checkpoint import save_checkpoint as vct_save_checkpoint
from vct_torch.bridge import load_vct_variables
from vct_torch.core import config
from vct_torch.data import ingest
from vct_torch.data.video import ParallelDecoder
from vct_torch.models import build_model
from vct_torch.serve import backend, deployment, worker
from vct_torch.serve.queue import QueuePull
from vct_torch.serve.store import ResultStore
from vct_torch.train.checkpoint import save_checkpoint

cv2 = pytest.importorskip("cv2")
T, HW = 4, 24
CLASSES = ["calm", "fight", "other"]
OVERRIDES = {"model.num_classes": "3", "model.cnn_backbone": "resnet18",
             "model.rnn_type": "mamba", "model.rnn_input_size": "8", "model.rnn_layer": "2",
             "model.scan_impl": "pallas", "data.sequence_length": str(T),
             "data.img_height": str(HW), "data.img_width": str(HW),
             "data.sampling_method": "sad"}
LENGTHS = (3, 9, 13, 20)  # one shorter than T, the rest longer
NAMES = [f"@user{i}_video_{100 + i}.mp4" for i in range(len(LENGTHS))]
URLS = [deployment.construct_url(n) for n in NAMES]
NO_URL = "clip.mp4"  # a file whose name maps to no URL


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """(vct checkpoint, vct_torch checkpoint, directory of the videos)."""
    root = tmp_path_factory.mktemp("worker")
    cfg_v = vct_config.Config().replace(**OVERRIDES)
    cfg_t = config.Config().replace(**OVERRIDES)
    flax_model = vct_build_model(cfg_v.model, T)
    variables = _random_variables(flax_model, np.zeros((1, T, HW, HW, 3), np.float32))
    vct_save_checkpoint(str(root / "ck_vct"), variables, cfg_v, CLASSES)
    model = build_model(cfg_t.model, T, device="cpu")
    load_vct_variables(model, variables)
    save_checkpoint(str(root / "ck_port"), model.state_dict(), cfg_t, CLASSES)
    rng = np.random.RandomState(0)
    src = root / "src"
    src.mkdir()
    for name, n in zip(NAMES + [NO_URL], LENGTHS + (7,)):
        write_video(src / name, rng.randint(0, 256, (n, 30, 34, 3), np.uint8))
    return str(root / "ck_vct"), str(root / "ck_port"), str(src)


def _decoders(monkeypatch):
    # vct decodes in one process (its pool forks, unsafe under JAX's
    # threads); the port's pool spawns two workers.
    monkeypatch.setattr(vct_ingest, "ParallelDecoder",
                        lambda workers=4, decoder="cv2": VctParallelDecoder(1, decoder))
    monkeypatch.setattr(ingest, "ParallelDecoder",
                        lambda workers=4, decoder="cv2": ParallelDecoder(2, decoder))


def _serve_cfg(model_path, tmp_path, **kw):
    return config.ServeConfig(model_path=model_path, sampling_method="sad", sequence_length=T,
                              video_dir=str(tmp_path / "videos"), queue_port=_free_port(), **kw)


@pytest.fixture(scope="module")
def workers(served, tmp_path_factory):
    """A ``vct`` and a ``vct_torch`` worker on the same weights, each loaded
    once; every test points them at its own directory and backend."""
    ck_vct, ck_port, _ = served
    tmp = tmp_path_factory.mktemp("workers")
    cfg_t = _serve_cfg(ck_port, tmp)
    cfg_v = vct_config.ServeConfig(**dataclasses.asdict(cfg_t) | {"model_path": ck_vct})
    with contextlib.redirect_stdout(io.StringIO()):
        return vct_worker.Worker(cfg_v), worker.Worker(cfg_t, device="cpu")


def _downloader(src):
    """Copies a message's video into the worker's directory: a TikTok URL
    gives the client's file name, any other message names the file."""

    def download(url, save_dir):
        match = re.search(r"(@[\w.]+)/video/(\d+)", url)
        name = f"{match.group(1)}_video_{match.group(2)}.mp4" if match else url
        shutil.copy(os.path.join(src, name), save_dir)

    return download


@contextlib.contextmanager
def _backend(store, fail=(), up=True):
    """The port's backend on ``store`` (no queue), answering 500 to a POST
    for a URL in ``fail``; with ``up`` False, the base URL of a port where
    nothing listens."""
    if not up:
        yield f"http://127.0.0.1:{_free_port()}"
        return
    base = backend.make_handler(store, None, poll_timeout=1.0)

    class Handler(base):
        def do_POST(self):
            body = self.rfile.read(int(self.headers.get("Content-Length", 0)))
            if json.loads(body).get("url") in fail:
                return self._json(500, {"error": "backend says no"})
            self.rfile = io.BytesIO(body)
            return super().do_POST()

    server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        yield f"http://127.0.0.1:{server.server_address[1]}"
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
        assert not thread.is_alive()


def _results(out):
    """Every JSON list ``classify_and_display`` printed, in order."""
    lines, found, start = out.splitlines(), [], 0
    while "[" in lines[start:]:
        start = lines.index("[", start)
        end = lines.index("]", start)
        found += json.loads("\n".join(lines[start:end + 1]))
        start = end + 1
    return found


# name: (files already in VIDEO_DIR, URLs the store already holds, URLs the
# backend answers 500 to, whether the backend is up, the messages)
SCENARIOS = {
    "confirmed": ([], [], [], True, [URLS[0], URLS[1]]),
    "one_url_answered_500": ([NAMES[2]], [], [URLS[2]], True, [URLS[0]]),
    "backend_down": ([], [], [], False, [URLS[0], URLS[1]]),
    "name_without_url": ([], [], [], True, [NO_URL, URLS[3]]),
    "leftover_confirmed": ([NAMES[3]], [URLS[3]], [], True, [URLS[1]]),
}


def _run_scenario(w, root, src, scenario):
    leftovers, known, fail, up, messages = scenario
    video_dir = root / "videos"
    video_dir.mkdir(parents=True)
    for name in leftovers:
        shutil.copy(os.path.join(src, name), video_dir)
    store = ResultStore(str(root / "results.db"))
    for url in known:
        store.insert(url, ["other"], [1.0], "earlier")
    out = io.StringIO()
    with _backend(store, fail, up) as base, contextlib.redirect_stdout(out):
        w.cfg = dataclasses.replace(w.cfg, video_dir=str(video_dir), backend_base_url=base)
        w.downloader = _downloader(src)
        for message in messages:
            w.callback(message)
    rows = sorted((r["url"], r["labels"], r["scores"]) for r in store.all())
    return _results(out.getvalue()), sorted(os.listdir(video_dir)), rows, out.getvalue()


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_worker_serves_a_message_as_vct(workers, served, name, tmp_path, monkeypatch):
    _decoders(monkeypatch)
    vct_w, port_w = workers
    src = served[2]
    want, want_left, want_rows, want_out = _run_scenario(vct_w, tmp_path / "vct", src,
                                                         SCENARIOS[name])
    got, got_left, got_rows, got_out = _run_scenario(port_w, tmp_path / "port", src,
                                                     SCENARIOS[name])
    assert [r["video_name"] for r in got] == [r["video_name"] for r in want]
    assert got, "the worker classified nothing"
    for g, w in zip(got, want):
        assert g["labels"] == w["labels"]
        np.testing.assert_allclose(g["scores"], w["scores"], atol=1e-4)
    assert got_left == want_left
    assert [r[:2] for r in got_rows] == [r[:2] for r in want_rows]
    for g, w in zip(got_rows, want_rows):
        np.testing.assert_allclose(g[2], w[2], atol=1e-4)
    said = ("Keeping ", "Dropping ", "Deleted already-classified", "No videos to classify")
    assert ([l for l in got_out.splitlines() if l.startswith(said)]
            == [l for l in want_out.splitlines() if l.startswith(said)])
    kept = {"confirmed": [], "one_url_answered_500": [NAMES[2]],
            "backend_down": NAMES[:2], "name_without_url": [], "leftover_confirmed": []}
    assert got_left == kept[name]


def test_the_whole_loop_returns_labels_to_the_client(served, tmp_path, monkeypatch):
    """Client -> ``GET /get_labels`` -> the queue -> the worker (download,
    decode, classify) -> ``POST /classify`` -> the store -> the client."""
    _decoders(monkeypatch)
    _, ck_port, src = served
    cfg = _serve_cfg(ck_port, tmp_path, backend_host="127.0.0.1", backend_port=_free_port(),
                     db_path=str(tmp_path / "results.db"))
    cfg = dataclasses.replace(cfg, backend_base_url=f"http://127.0.0.1:{cfg.backend_port}")
    store = ResultStore(cfg.db_path)
    server = backend.make_server(cfg, store=store, poll_timeout=30.0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    w = worker.Worker(cfg, downloader=_downloader(src), device="cpu")
    w.pull = QueuePull(host="127.0.0.1", port=cfg.queue_port)
    w.pull.bind()
    thread = threading.Thread(target=w.run, daemon=True)
    thread.start()
    try:
        replies = [requests.get(f"{cfg.backend_base_url}/get_labels", params={"url": url},
                                timeout=60) for url in URLS[:2] + URLS[:1]]
    finally:
        w.pull.close()
        thread.join(timeout=10)
        server.shutdown()
        server.server_close()
    assert not thread.is_alive()
    assert [r.status_code for r in replies] == [200, 200, 200]
    assert [r.json()["url"] for r in replies] == URLS[:2] + URLS[:1]
    rows = {r["url"]: r for r in store.all()}
    assert sorted(rows) == sorted(URLS[:2])
    for r in replies:
        assert r.json()["labels"] == rows[r.json()["url"]]["labels"]
        assert sorted(r.json()["labels"]) == sorted(CLASSES)
    assert os.listdir(cfg.video_dir) == []  # every confirmed file is gone
    # The same video classified in process gives the client's labels.
    model, class_names, _ = deployment.load_model(ck_port, device="cpu")
    clips, _ = ingest.load_dataset_inference(src, "sad", T, HW, HW, skip=NAMES[1:] + [NO_URL])
    probs = deployment.classify_videos(model, clips, device="cpu")[0]
    assert rows[URLS[0]]["labels"] == [class_names[i] for i in np.argsort(-probs)]
    np.testing.assert_allclose(rows[URLS[0]]["scores"], np.sort(probs)[::-1], atol=1e-6)


def test_worker_refusals(served, tmp_path, monkeypatch):
    _, ck_port, _ = served
    artifact = tmp_path / "m.vctaot"
    artifact.write_bytes(b"")
    with pytest.raises(ValueError, match="not a vct-torch-aot-v1 artifact"):
        worker.Worker(_serve_cfg(str(artifact), tmp_path), device="cpu")
    with zipfile.ZipFile(artifact, "w") as zf:
        zf.writestr("manifest.json", json.dumps({"format": "vct-aot-v1", "platform": "cpu"}))
    with pytest.raises(ValueError, match="convert_vct_checkpoint.py SRC DST"):
        worker.Worker(_serve_cfg(str(artifact), tmp_path), device="cpu")
    cfg = _serve_cfg(ck_port, tmp_path)
    monkeypatch.setenv("VCT_WORKER_MESH", "1")
    cpu = torch.device("cpu")
    monkeypatch.setattr(deployment, "visible_devices", lambda dev: [cpu, cpu])
    mesh = worker.Worker(cfg, device="cpu").mesh  # two devices: a replica each
    assert mesh.shape == {"data": 2, "model": 1} and list(mesh.grid[:, 0]) == [cpu, cpu]
    monkeypatch.setattr(deployment, "visible_devices", lambda dev: [cpu])
    one = worker.Worker(cfg, device="cpu")
    assert one.device == cpu and one.mesh is None  # one card: no change
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        worker.Worker(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        worker.run_worker(cfg)


@pytest.mark.parametrize("env", [{}, {"MODEL_PATH": "/models/m", "SAMPLING_METHOD": "ssim",
                                      "SEQUENCE_LENGTH": "30", "VIDEO_DIR": "/data/v",
                                      "QUEUE_PORT": "54001", "APP_STAGE": "prod",
                                      "BACKEND_URL": "http://elsewhere:9000"}])
def test_run_worker_reads_the_environment_as_vct(env, monkeypatch):
    for key in ("MODEL_PATH", "SAMPLING_METHOD", "SEQUENCE_LENGTH", "VIDEO_DIR", "QUEUE_PORT",
                "APP_STAGE", "BACKEND_URL"):
        monkeypatch.delenv(key, raising=False)
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    made = []

    class Recorder:
        def __init__(self, cfg, downloader=None, device=None):
            made.append((dataclasses.asdict(cfg), device, cfg.backend_url, cfg.backend_checker))

        def run(self):
            pass

    import vct.utils.compilecache

    monkeypatch.setattr(vct.utils.compilecache, "enable_persistent_compile_cache", lambda: None)
    monkeypatch.setattr(vct_worker, "Worker", Recorder)
    monkeypatch.setattr(worker, "Worker", Recorder)
    vct_worker.run_worker()
    worker.run_worker(device="cpu")
    (want, _, *want_urls), (got, device, *got_urls) = made
    assert got == want and got_urls == want_urls and device == "cpu"


# ---------------------------------------------------------------------------
# a request's clips go to the device one batch at a time


def test_classify_videos_moves_one_chunk_at_a_time(served, monkeypatch):
    """Every clip tensor that ``classify_videos`` moves holds at most one
    ``batch_size`` chunk, from host arrays and from tensors; the
    probabilities are ``vct``'s."""
    ck_vct, ck_port, _ = served
    model, _, _ = deployment.load_model(ck_port, device="cpu")
    clips = np.random.RandomState(1).rand(5, T, HW, HW, 3).astype(np.float32)
    moved = []
    to = torch.Tensor.to

    def spy(self, *args, **kwargs):
        if tuple(self.shape[1:]) == clips.shape[1:]:
            moved.append(len(self))
        return to(self, *args, **kwargs)

    monkeypatch.setattr(torch.Tensor, "to", spy)
    got = [deployment.classify_videos(model, x, batch_size=2, device="cpu")
           for x in (clips, torch.from_numpy(clips))]
    monkeypatch.undo()
    assert moved and max(moved) == 2
    vct_model, variables, _, _ = vct_deployment.load_model(ck_vct)
    want = vct_deployment.classify_videos(vct_model, variables, clips, batch_size=2)
    for probs in got:
        assert probs.shape == (5, len(CLASSES))
        np.testing.assert_allclose(probs, want, atol=1e-4)


def test_device_sampling_returns_host_clips_as_vct(served, capsys):
    _, _, src = served
    got, names = deployment._load_with_device_sampling(src, "sad", T, HW, HW, device="cpu")
    got_out = capsys.readouterr().out
    want, want_names = vct_deployment._load_with_device_sampling(src, "sad", T, HW, HW)
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    assert names == want_names == sorted(NAMES + [NO_URL])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    assert got_out == capsys.readouterr().out  # "Final data shape: (5, 4, 24, 24, 3)"


def test_cli_probabilities_are_vct_s_with_device_sampling(served, monkeypatch):
    ck_vct, ck_port, src = served
    args = ["--videos", src, "--device_sampling", "--sampling", "sad", "--batch_size", "2"]
    outs = []
    for main, argv in ((vct_deployment.main, ["--model", ck_vct, *args]),
                       (deployment.main, ["--model", ck_port, *args, "--device", "cpu"])):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            assert main(argv) == 0
        outs.append(_results(out.getvalue()))
    want, got = outs
    assert [r["video_name"] for r in got] == [r["video_name"] for r in want]
    for g, w in zip(got, want):
        assert g["labels"] == w["labels"]
        np.testing.assert_allclose(g["scores"], w["scores"], atol=1e-4)
