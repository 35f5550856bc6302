"""End-to-end serving rehearsal on the card: the port of
``vct/tools/serve_rehearsal.py``.

The CPU tests cover the backend, worker and queue plumbing with local
stand-ins; this script rehearses the production serving story on the card
with nothing faked but the TikTok download (a machine without network: the
"download" copies a real encoded mp4 from a local source directory, and
everything after it is the production path):

  train (``python -m vct_torch.train``, motion dataset, real ingest)
    -> AOT export (``python -m vct_torch.serve.aot`` -> one ``.vctaot`` file)
    -> backend HTTP server (stdlib ThreadingHTTPServer + sqlite ResultStore)
       + queue worker subprocess (loads the artifact, classifies on the card)
    -> client: GET /video_labels miss -> GET /get_labels -> queue PUSH ->
       worker: download -> cv2 decode -> classify on the card -> POST
       /classify -> sqlite -> poll satisfied -> labels; then /video_labels
       readback
    -> deployment CLI (``python -m vct_torch.serve.deployment --model
       *.vctaot``) over the same directory of mp4s.

Labels are CHECKED, not just returned: the held-out serving videos come from
``generate_motion_dataset`` with a fresh seed, so every /get_labels response
must name the clip's true motion class. Reference counterparts:
``medsos_lrcn/src/backend.py:36-118``, ``worker.py:104-155``,
``deployment.py:61-191``.

The one difference from ``vct``'s training argv: ``--data.cache_format
clipcache`` (the port's clip cache in place of HDF5, which the card's
machine lacks: it has no h5py). ``--device cpu`` runs every step on the CPU.
The backend and the queue take free ports, and ``--out`` defaults to a new
temporary directory, so rehearsals on one host do not collide.

Run:  python -m vct_torch.tools.serve_rehearsal [--out DIR] [--epochs 50] [--device cpu]
It prints one JSON summary line last.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import socket
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.parse
import urllib.request

# vct's --train.seed.
TRAIN_SEED = 11


def _free_port() -> int:
    """A port that nothing on this host listens on now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _http_get(url: str, timeout: float = 180.0):
    """(status, json_body) without raising on 4xx."""
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.status, json.loads(r.read().decode())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read().decode() or "{}")


def _wait_port(port: int, proc=None, log_path: str = "",
               deadline_s: float = 900.0) -> None:
    """Wait for ``port`` to accept connections; fail FAST (with the log
    tail) if ``proc`` dies first instead of burning the whole deadline."""
    t0 = time.time()
    while time.time() - t0 < deadline_s:
        if proc is not None and proc.poll() is not None:
            tail = ""
            if log_path and os.path.exists(log_path):
                with open(log_path) as f:
                    tail = "".join(f.readlines()[-15:])
            raise RuntimeError(
                f"worker exited rc={proc.returncode} before binding port "
                f"{port}:\n{tail}"
            )
        try:
            with socket.create_connection(("127.0.0.1", port), timeout=1.0):
                return
        except OSError:
            time.sleep(0.5)
    raise TimeoutError(f"port {port} never came up")


def _run_logged(cmd, log, env=None) -> tuple[int, str]:
    """Run a subprocess, stream its output to stdout AND the transcript."""
    print(f"$ {' '.join(cmd)}", flush=True)
    log.write(f"$ {' '.join(cmd)}\n")
    p = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env,
    )
    out = []
    for line in p.stdout:
        print("  | " + line, end="", flush=True)
        log.write("  | " + line)
        out.append(line)
    p.wait()
    log.flush()
    return p.returncode, "".join(out)


def worker_role(args) -> None:
    """The queue-worker subprocess: production Worker with the one
    environment substitution — the downloader copies the url's mp4 from the
    local source dir instead of hitting TikTok (zero-egress machine)."""
    from vct_torch.core.config import ServeConfig
    from vct_torch.serve.worker import Worker

    def local_download(url: str, save_dir: str) -> None:
        m = re.match(r"https://www\.tiktok\.com/(@[^/]+)/video/(\d+)", url)
        name = f"{m.group(1)}_video_{m.group(2)}.mp4"
        os.makedirs(save_dir, exist_ok=True)
        shutil.copy(os.path.join(args.source_dir, name),
                    os.path.join(save_dir, name))

    cfg = ServeConfig(
        model_path=args.art,
        video_dir=args.video_dir,
        queue_port=args.queue_port,
        backend_base_url=args.backend_url,
    )
    Worker(cfg, downloader=local_download, device=args.device).run()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None,
                    help="working directory (default: a new temporary directory)")
    ap.add_argument("--epochs", type=int, default=50)
    ap.add_argument("--role", default="client", choices=["client", "worker"])
    ap.add_argument("--art", help="(worker role) .vctaot path")
    ap.add_argument("--video-dir", help="(worker role) incoming video dir")
    ap.add_argument("--source-dir", help="(worker role) local mp4 source")
    ap.add_argument("--queue-port", type=int, help="(worker role) the queue's port")
    ap.add_argument("--backend-url", help="(worker role) the backend's base URL")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' to run on the CPU)")
    args = ap.parse_args(argv)
    if args.role == "worker":
        return worker_role(args)

    out = args.out or tempfile.mkdtemp(prefix="vct_serve_rehearsal_")
    os.makedirs(out, exist_ok=True)
    videos = os.path.join(out, "videos")
    ckpt = os.path.join(out, "ckpt")
    art = os.path.join(out, "model.vctaot")
    source = os.path.join(out, "source")
    incoming = os.path.join(out, "incoming")
    db = os.path.join(out, "results.db")
    if os.path.exists(db):
        os.remove(db)
    if os.path.exists(incoming):
        shutil.rmtree(incoming)
    log = open(os.path.join(out, "transcript.txt"), "w")
    summary: dict = {}

    device = ["--device", args.device] if args.device else []

    # -- phase 1: train a real checkpoint on the card (production CLI) -----
    from vct_torch.data.synthetic import generate_motion_dataset

    if not os.path.exists(videos):
        generate_motion_dataset(
            videos, clips_per_class=(16, 13, 13, 10), frames=16, size=64,
            seed=0,
        )
    t0 = time.time()
    rc, text = _run_logged([
        sys.executable, "-m", "vct_torch.train",
        "--data.dataset_path", videos,
        "--data.processed_data_path", os.path.join(out, "cache"),
        "--data.cache_format", "clipcache",
        "--data.img_height", "64", "--data.img_width", "64",
        "--data.sequence_length", "4", "--data.decode_workers", "0",
        "--model.num_classes", "4", "--model.rnn_input_size", "32",
        "--model.mult_factor", "2", "--model.cnn_backbone", "resnet18",
        "--model.rnn_type", "lstm", "--model.rnn_layer", "2",
        "--model.rnn_out", "all", "--model.dropout", "0.0",
        "--train.batch_size", "8", "--train.epochs", str(args.epochs),
        "--train.learning_rate", "1e-3", "--train.feature_cache", "true",
        "--train.weighted_loss", "true", "--train.seed", str(TRAIN_SEED),
        "--train.save_model", "true", "--train.model_path", ckpt, *device,
    ], log)
    if rc != 0:
        raise RuntimeError("training failed")
    summary["train_s"] = round(time.time() - t0, 1)
    m = re.search(r"Overall Accuracy:\s*([\d.]+)", text)
    summary["train_heldout_acc"] = float(m.group(1)) if m else None

    # -- phase 2: export the AOT servable artifact -------------------------
    t0 = time.time()
    rc, _ = _run_logged([
        sys.executable, "-m", "vct_torch.serve.aot",
        "--model", ckpt, "--out", art, "--batches", "1,8", *device,
    ], log)
    if rc != 0:
        raise RuntimeError("AOT export failed")
    summary["export_s"] = round(time.time() - t0, 1)
    summary["artifact_mb"] = round(os.path.getsize(art) / 1e6, 2)

    # -- phase 3: held-out serving videos (fresh generator seed) -----------
    heldout = os.path.join(out, "heldout")
    if not os.path.exists(heldout):
        class_names = generate_motion_dataset(
            heldout, clips_per_class=(2, 2, 2, 2), frames=16, size=64,
            seed=777,
        )
    else:
        class_names = sorted(os.listdir(heldout))
    os.makedirs(source, exist_ok=True)
    truth: dict[str, str] = {}  # url -> true class
    vid = 0
    for cls in class_names:
        for clip in sorted(os.listdir(os.path.join(heldout, cls))):
            vid += 1
            name = f"@rehearsal_video_{vid}.mp4"
            shutil.copy(os.path.join(heldout, cls, clip),
                        os.path.join(source, name))
            truth[f"https://www.tiktok.com/@rehearsal/video/{vid}"] = cls
    urls = list(truth)
    print(f"serving corpus: {len(urls)} held-out mp4s in {source}")
    log.write(f"serving corpus: {len(urls)} held-out mp4s in {source}\n")

    # -- phase 4: backend (in-process thread) + worker (subprocess) --------
    from vct_torch.core.config import ServeConfig
    from vct_torch.serve.backend import make_server

    queue_port = _free_port()
    scfg = ServeConfig(backend_host="127.0.0.1", backend_port=0,
                       queue_port=queue_port, db_path=db)
    server = make_server(scfg, poll_timeout=180.0)
    base = f"http://127.0.0.1:{server.server_address[1]}"
    threading.Thread(target=server.serve_forever, daemon=True).start()
    print(f"backend listening on {base} (sqlite: {db})")
    log.write(f"backend listening on {base}\n")

    worker_log = open(os.path.join(out, "worker.log"), "w")
    worker = subprocess.Popen(
        [sys.executable, "-m", "vct_torch.tools.serve_rehearsal", "--role",
         "worker", "--art", art, "--video-dir", incoming,
         "--source-dir", source, "--queue-port", str(queue_port),
         "--backend-url", base, *device],
        stdout=worker_log, stderr=subprocess.STDOUT, text=True,
    )
    try:
        t0 = time.time()
        # The worker binds its PULL port only after the artifact's load and
        # warmup (the kernels' build included).
        _wait_port(queue_port, proc=worker,
                   log_path=os.path.join(out, "worker.log"))
        summary["worker_ready_s"] = round(time.time() - t0, 1)
        print(f"worker up (artifact loaded + warm) in "
              f"{summary['worker_ready_s']} s")
        # -- phase 5: the client flow --------------------------------------
        q = urllib.parse.quote(urls[0], safe="")
        code, body = _http_get(f"{base}/video_labels?url={q}")
        if code != 404:
            raise RuntimeError(f"GET /video_labels of an unclassified URL: {code} {body}")
        print(f"GET /video_labels (unclassified) -> 404 {body}")
        log.write(f"GET /video_labels (unclassified) -> 404 {body}\n")

        lat, correct = [], 0
        for url in urls:
            q = urllib.parse.quote(url, safe="")
            t0 = time.time()
            code, body = _http_get(f"{base}/get_labels?url={q}")
            dt = time.time() - t0
            lat.append(dt)
            ok = code == 200 and body.get("labels", [None])[0] == truth[url]
            correct += ok
            line = (f"GET /get_labels {url} -> {code} top={body.get('labels', ['?'])[0]}"
                    f" truth={truth[url]} {'OK' if ok else 'WRONG'} {dt:.2f}s")
            print(line)
            log.write(line + "\n")
        summary["get_labels_first_s"] = round(lat[0], 2)
        summary["get_labels_steady_s"] = round(sum(lat[1:]) / len(lat[1:]), 2)
        summary["correct"] = f"{correct}/{len(urls)}"

        t0 = time.time()
        for url in urls:
            q = urllib.parse.quote(url, safe="")
            code, body = _http_get(f"{base}/video_labels?url={q}")
            if code != 200 or body["labels"][0] != truth[url]:
                raise RuntimeError(f"GET /video_labels {url}: {code} {body}")
        summary["video_labels_readback_ms"] = round(
            (time.time() - t0) / len(urls) * 1000, 1)
        print(f"/video_labels readback x{len(urls)}: "
              f"{summary['video_labels_readback_ms']} ms/request (sqlite)")
        leftover = os.listdir(incoming) if os.path.exists(incoming) else []
        summary["incoming_leftover"] = len(leftover)  # confirmed -> deleted
    finally:
        worker.terminate()
        worker.wait(timeout=30)
        worker_log.close()
        server.shutdown()

    # -- phase 6: the deployment CLI over the same mp4 directory -----------
    t0 = time.time()
    rc, text = _run_logged([
        sys.executable, "-m", "vct_torch.serve.deployment",
        "--model", art, "--videos", source, *device,
    ], log)
    if rc != 0:
        raise RuntimeError("deployment CLI failed")
    summary["deployment_cli_s"] = round(time.time() - t0, 1)
    name_truth = {  # "@rehearsal_video_<i>.mp4" -> true class
        f"@rehearsal_video_{u.rsplit('/', 1)[1]}.mp4": c
        for u, c in truth.items()
    }
    preds = re.findall(r"Processed (\S+): (\S+)", text)
    summary["deployment_cli_correct"] = (
        f"{sum(name_truth.get(n) == c for n, c in preds)}/{len(preds)}"
    )

    print(json.dumps(summary))
    log.write(json.dumps(summary) + "\n")
    log.close()
    with open(os.path.join(out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)


if __name__ == "__main__":
    main()
