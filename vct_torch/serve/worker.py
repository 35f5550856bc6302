"""Queue inference worker (C21): the port of ``vct/serve/worker.py``.

Bind the PULL queue, and for each URL message download the video (the
TikTok client, or an injected ``downloader``), decode and select its frames
on the host (``load_dataset_inference``), classify every video of
``VIDEO_DIR`` not yet classified on the worker's device, and POST the results
to the backend. As in ``vct``:

  * the model loads **once** at startup;
  * processed files are removed only after the backend confirmed their
    result, and leftovers only once the backend's checker answers with
    their labels; a file whose name maps to no URL is removed after its one
    classification.

Configuration through environment variables, as ``vct``'s: MODEL_PATH (a
``vct_torch`` checkpoint directory, or a ``.vctaot`` artifact file, served
through ``vct_torch.serve.aot.AotServable`` and warmed before the queue is
bound), SAMPLING_METHOD, SEQUENCE_LENGTH, VIDEO_DIR, QUEUE_PORT, APP_STAGE
and BACKEND_URL; ``device`` (default: the card) says where the model runs.
``python -m vct_torch.serve.worker`` runs it.

``VCT_WORKER_MESH=1`` serves a checkpoint across every visible card (one
replica a card, ``deployment.classify_videos``'s mesh); on one card it
changes nothing, as in ``vct``. ``vct``'s persistent compile cache is XLA's
and has no counterpart here.
"""

from __future__ import annotations

import dataclasses
import json
import os
import urllib.parse
import urllib.request
from typing import Optional

from vct_torch.core.config import ServeConfig
from vct_torch.data.ingest import load_dataset_inference
from vct_torch.device import resolve_device
from vct_torch.serve import deployment
from vct_torch.serve.deployment import (classify_and_display, construct_url, load_model,
                                        post_results)
from vct_torch.serve.queue import QueuePull

__all__ = ["Worker", "run_worker"]


class Worker:
    def __init__(self, cfg: ServeConfig, downloader=None, device=None):
        self.cfg = cfg
        self.downloader = downloader  # callable(url, save_dir) -> None
        print(f"Loading model from {cfg.model_path}")
        self.device = resolve_device(device)
        self.servable = None
        if os.path.isfile(cfg.model_path):
            # MODEL_PATH is a .vctaot artifact: weights and forward in one
            # file, no model zoo, config or checkpoint restore in the path.
            from vct_torch.serve.aot import AotServable

            self.servable = AotServable.load(cfg.model_path, device=self.device)
            if self.servable.device_sampling:
                raise ValueError(
                    "this artifact bakes on-device sampling in (raw-input "
                    "contract, AotServable.classify_raw); the worker feeds "
                    "pre-sampled clips — export without --device_sampling "
                    "for worker serving"
                )
            self.model = self.model_cfg = None
            self.class_names = self.servable.class_names
            art_T = self.servable.input_shape[0]
            if cfg.sequence_length != art_T:
                print(f"SEQUENCE_LENGTH={cfg.sequence_length} overridden to {art_T}: the "
                      f"artifact's programs are exported for T={art_T}")
                self.cfg = cfg = dataclasses.replace(cfg, sequence_length=art_T)
            # The programs' first run pays one-time costs (the kernels'
            # build and plans, cuDNN's choices) that belong at start-up, not
            # in the first user request.
            self.servable.warmup()
            if self.servable.sampling_method and "SAMPLING_METHOD" not in os.environ:
                # No explicit override: preprocess as the model was trained
                # (the manifest records it).
                self.cfg = cfg = dataclasses.replace(
                    cfg, sampling_method=self.servable.sampling_method)
        else:
            self.model, self.class_names, self.model_cfg = load_model(
                cfg.model_path, device=self.device)
        self.pull = QueuePull(port=cfg.queue_port)
        self.mesh = None
        if os.environ.get("VCT_WORKER_MESH") == "1":
            devices = deployment.visible_devices(self.device)
            if len(devices) > 1:
                self.mesh = deployment.make_mesh(devices, model=1)
                print(f"worker sharding inference over {self.mesh.size} devices")

    def callback(self, url: str) -> None:
        print(f"Processing message: {url}")
        os.makedirs(self.cfg.video_dir, exist_ok=True)
        if self.downloader is not None:
            self.downloader(url, self.cfg.video_dir)
        else:
            from vct_torch.serve.tiktok import save_tiktok_multi_urls

            save_tiktok_multi_urls([url], save_video=True,
                                   save_dir=self.cfg.video_dir)

        if self.servable is not None:
            img_h, img_w = self.servable.input_shape[1:3]
        else:
            img_h, img_w = self.model_cfg.data.img_height, self.model_cfg.data.img_width
        clips, names = load_dataset_inference(
            self.cfg.video_dir,
            sampling_method=self.cfg.sampling_method,
            sequence_length=self.cfg.sequence_length,
            img_height=img_h,
            img_width=img_w,
            skip=self._already_classified(),
        )
        if len(names) == 0:
            print("No videos to classify.")
            return
        results = classify_and_display(
            self.model, clips, names, self.class_names, device=self.device, mesh=self.mesh,
            probs=self.servable.classify(clips) if self.servable is not None else None)
        posted = post_results(results, self.cfg.backend_url)
        # Delete videos whose result the backend confirmed. Transient
        # failures (valid URL, backend down/5xx) stay on disk and retry via
        # the _already_classified/leftover path; files whose name can never
        # map back to a URL are unconfirmable — keeping those would re-run
        # inference on them for every future message, so they are removed
        # after their one classification.
        for name in names:
            if not posted.get(name) and construct_url(name) is not None:
                print(f"Keeping {name} for retry (result not confirmed)")
                continue
            if not posted.get(name):
                print(f"Dropping {name}: no reconstructable URL to confirm")
            path = os.path.join(self.cfg.video_dir, name)
            try:
                os.remove(path)
            except OSError:
                pass

    def _already_classified(self):
        """Video filenames in VIDEO_DIR whose URLs the backend already has
        labels for. Confirmed-classified leftovers (e.g. from a crash between
        POST and cleanup) are deleted here, after the backend confirms it has
        their labels, so the directory and the per-message check stay
        bounded."""
        skip = []
        try:
            for fname in os.listdir(self.cfg.video_dir):
                url = construct_url(fname)
                if not url:
                    continue
                query = urllib.parse.urlencode({"url": url})
                try:
                    with urllib.request.urlopen(f"{self.cfg.backend_checker}?{query}",
                                                timeout=5) as r:
                        confirmed = r.status == 200 and "labels" in json.loads(r.read())
                except Exception:  # no answer, an error status, no JSON: not confirmed
                    continue
                if confirmed:
                    skip.append(fname)
                    try:
                        os.remove(os.path.join(self.cfg.video_dir, fname))
                        print(f"Deleted already-classified video: {fname}")
                    except OSError:
                        pass
        except FileNotFoundError:
            pass
        return skip

    def run(self) -> None:
        print(f"worker pulling on :{self.cfg.queue_port}")
        self.pull.consume(self.callback)


def run_worker(cfg: Optional[ServeConfig] = None, device=None) -> None:
    cfg = cfg or ServeConfig(
        model_path=os.environ.get("MODEL_PATH", ""),
        sampling_method=os.environ.get("SAMPLING_METHOD", "uniform"),
        sequence_length=int(os.environ.get("SEQUENCE_LENGTH", "60")),
        video_dir=os.environ.get("VIDEO_DIR", "/tmp/vct_videos"),
        queue_port=int(os.environ.get("QUEUE_PORT", "54000")),
        app_stage=os.environ.get("APP_STAGE", "devel"),
        backend_base_url=os.environ.get("BACKEND_URL", ""),
    )
    Worker(cfg, device=device).run()


if __name__ == "__main__":
    run_worker()
