"""Batch inference: video files -> frame selection -> batched softmax, and
the CLI ``python -m vct_torch.serve.deployment``.

Port of ``vct/serve/deployment.py``:

* ``sample_decoded_clips`` — the post-decode half of
  ``_load_with_device_sampling``: short videos are cycled up to T, longer
  ones are padded to a power-of-two length bucket and go through on-device
  frame selection (``device_sample_clips``) with their true length: SAD
  and flow scores from the ``pair_scores`` kernel, SSIM scores (``ssim``,
  ``ssim_most_unique``) from the ``ssim_pair_scores`` kernel.
* ``classify_videos`` — batched softmax probabilities, one chunk moved to
  the device at a time, the final partial chunk zero-padded to
  ``batch_size`` so every forward has one shape. With ``mesh`` (a device
  mesh of ``vct_torch.parallel``) one model replica a data row: each chunk
  is padded to a multiple of the data axis, each row's slice runs on its
  row's device, and the rows come back in order.
* ``classify_and_display`` — the reference's output contract: per-video
  sorted labels and scores with a timestamp as JSON, ``Processed <name>:
  <label>`` lines and the label counts.

* ``load_model`` — rebuild a model from a vct_torch checkpoint on the card.
* ``post_results`` — POST each result to the backend (standard library
  ``urllib``, the payload and 10 s timeout of ``vct``'s ``requests`` call).
* ``_load_with_device_sampling`` — decode every frame on the host, then
  ``sample_decoded_clips`` on the device, one video at a time, each
  selected clip back to the host.
* ``main`` — the CLI: ``--model`` a vct_torch checkpoint directory or a
  ``.vctaot`` artifact file (``vct_torch.serve.aot.AotServable``: weights
  and forward in one file, no model zoo in the path) and ``--videos DIR``
  (host sampling through ``load_dataset_inference``, or
  ``--device_sampling``) or ``--frames DIR``; ``--post``; ``--device``;
  ``--mesh`` serves across every visible card (on one card it changes
  nothing, as in ``vct``).
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
import urllib.error
import urllib.request
import weakref
from collections import Counter
from datetime import datetime
from typing import TYPE_CHECKING, List, Optional, Sequence

import numpy as np

from vct_torch.device import resolve_device
from vct_torch.parallel.mesh import make_mesh, visible_devices

if TYPE_CHECKING:
    import torch

# torch, the models and the kernels are imported by the functions that use
# them: the CLI's spawned decode workers import this module as their main
# module, and need none of them.

__all__ = [
    "construct_url",
    "load_model",
    "sample_decoded_clips",
    "classify_videos",
    "classify_and_display",
    "post_results",
    "main",
]


def construct_url(video_name: str) -> Optional[str]:
    """'@user_video_123.mp4' -> tiktok URL."""
    match = re.match(r"(?P<username>@.+?)_video_(?P<video_id>\d+)", video_name)
    if match:
        return (
            f"https://www.tiktok.com/{match.group('username')}"
            f"/video/{match.group('video_id')}"
        )
    return None


def load_model(model_dir: str, device=None):
    """Rebuild (model, class_names, cfg) from a vct_torch checkpoint
    directory, on ``device`` (default: the card), in eval mode. A ``vct``
    (Orbax) checkpoint raises ``ValueError``; a tensor that does not match
    the rebuilt model raises (``load_weights``)."""
    from vct_torch.models import build_model
    from vct_torch.train.checkpoint import load_checkpoint, load_weights

    state_dict, cfg, class_names, _ = load_checkpoint(model_dir)
    model = build_model(cfg.model, cfg.data.sequence_length, device=device,
                        frame_size=(cfg.data.img_height, cfg.data.img_width))
    load_weights(model, state_dict, model_dir)
    return model.eval(), class_names, cfg


_DEVICE_METHODS = {
    "uniform": "uniform",
    # uniform_seek only decodes differently; on decoded frames it is uniform.
    "uniform_seek": "uniform",
    "ssim": "ssim",
    "sad": "sad",
    "optical_flow": "flow",
    "optiflow": "flow",
    # The *_most_unique variants map to the plain transition-score selectors.
    "ssim_most_unique": "ssim",
    "optiflow_most_unique": "flow",
}


def _length_bucket(n_frames: int, seq_len: int) -> int:
    """Pad decoded length up to seq_len * 2^k: at most 2x selection work and
    a log-bounded number of distinct input shapes across arbitrary videos."""
    bucket = seq_len * 2
    while bucket < n_frames:
        bucket *= 2
    return bucket


def sample_decoded_clips(frames_per_video: Sequence[np.ndarray], sampling: str,
                         seq_len: int, device=None) -> torch.Tensor:
    """Decoded uint8 videos (a list of (n_i, H, W, 3) arrays) -> (N, T, H, W, 3)
    f32 clips on ``device`` (default: the card), one per video.

    Raises ``KeyError`` for an unknown sampling method and ``ValueError``
    for a video without frames.
    """
    import torch

    from vct_torch.data.preprocess import device_sample_clips, preprocess_clips
    from vct_torch.data.samplers import duplicate_frames

    if sampling not in _DEVICE_METHODS:
        raise KeyError(
            f"Unknown sampling method {sampling!r} for --device_sampling; "
            f"available: {sorted(_DEVICE_METHODS)}"
        )
    dev = resolve_device(device)
    method = _DEVICE_METHODS[sampling]
    clips = []
    for i, frames in enumerate(frames_per_video):
        frames = np.asarray(frames)
        n = len(frames)
        if n == 0:
            raise ValueError(f"video {i} has no frames")
        if n <= seq_len:
            padded = np.stack(duplicate_frames(list(frames), seq_len))[None]
            clip = preprocess_clips(torch.from_numpy(padded).to(dev))
        else:
            bucket = _length_bucket(n, seq_len)
            raw = np.empty((1, bucket) + frames.shape[1:], np.uint8)
            raw[0, :n] = frames
            raw[0, n:] = frames[-1]  # pad tail; masked out of selection
            clip = device_sample_clips(
                torch.from_numpy(raw).to(dev), seq_len, method=method,
                lengths=torch.tensor([n], device=dev),
            )
        clips.append(clip[0])
    if not clips:
        raise ValueError("no videos to sample")
    return torch.stack(clips)


_replicas = weakref.WeakKeyDictionary()  # model -> (mesh devices, replicas)


def mesh_replicas(model, mesh) -> list:
    """One replica of ``model`` a data row of ``mesh`` (a device mesh), on
    the row's device: the model itself where it lives there, a copy
    elsewhere; kept for the next call with the same devices (the worker
    serves many requests with one model)."""
    from vct_torch.parallel.mesh import host_to_device

    key = tuple(str(row[0]) for row in mesh.grid)
    cached = _replicas.get(model)
    if cached is None or cached[0] != key:
        cached = (key, host_to_device(model, mesh))
        _replicas[model] = cached
    return cached[1]


def classify_videos(model, clips, batch_size: int = 32, device=None, mesh=None) -> np.ndarray:
    """Softmax probabilities (N, num_classes) for (N, T, H, W, 3) clips.

    ``model`` must live on ``device`` (default: the card). ``clips`` stay
    where they are (host memory for the worker and the CLI): one
    ``batch_size`` chunk at a time is moved to the device, so the device
    holds one chunk, however many clips there are. The final partial chunk
    zero-pads up to ``batch_size``.

    With ``mesh`` (a device mesh, ``vct_torch.parallel.make_mesh``) the
    chunk pads up to a multiple of the data axis and splits into one slice
    a data row, each run by the row's replica on the row's device (one
    chunk on the cards at a time still), the rows gathered in order.
    """
    import torch

    if mesh is not None and mesh.distributed:
        raise ValueError(f"{mesh}: serving spans the cards of one process; pass a device "
                         "mesh (make_mesh(devices))")
    if mesh is not None and mesh.size > 1:
        rows = mesh.shape["data"]
        batch_size = -(-batch_size // rows) * rows
        replicas = list(zip(mesh_replicas(model, mesh), [row[0] for row in mesh.grid]))
    else:
        replicas = [(model, resolve_device(device))]
    k = batch_size // len(replicas)
    probs = []
    with torch.inference_mode():
        for start in range(0, len(clips), batch_size):
            chunk = torch.as_tensor(clips[start:start + batch_size])
            n = len(chunk)
            if n < batch_size:
                pad = chunk.new_zeros((batch_size - n,) + tuple(chunk.shape[1:]))
                chunk = torch.cat([chunk, pad])
            parts = [replica(chunk[i * k:(i + 1) * k].to(dev, torch.float32))
                     for i, (replica, dev) in enumerate(replicas)]
            p = torch.cat([torch.softmax(q.to(torch.float32), dim=-1).cpu() for q in parts])
            probs.append(p[:n].numpy())
            del chunk, parts, p  # free this chunk before the next one is moved
    return np.concatenate(probs) if probs else np.zeros((0,), np.float32)


def classify_and_display(
    model, clips, video_names: List[str], class_names: List[str],
    batch_size: int = 32, probs: Optional[np.ndarray] = None, device=None, mesh=None,
) -> List[dict]:
    """The reference's output contract; ``probs`` skips the forward for
    callers that already have probabilities."""
    results = []
    label_counter = Counter()
    if probs is None:
        probs = classify_videos(model, clips, batch_size=batch_size, device=device, mesh=mesh)
    for idx, name in enumerate(video_names):
        order = np.argsort(-probs[idx])
        sorted_labels = [class_names[i] for i in order]
        sorted_scores = probs[idx][order].tolist()
        results.append(
            {
                "video_name": name,
                "labels": sorted_labels,
                "scores": sorted_scores,
                "timestamp": datetime.now().isoformat(),
            }
        )
        label_counter[sorted_labels[0]] += 1
        print(f"Processed {name}: {sorted_labels[0]}")

    print(json.dumps(results, indent=4))
    print("\nLabel Counts:")
    for label, count in label_counter.items():
        print(f"{label}: {count}")
    return results


def post_results(results: List[dict], backend_url: str) -> dict:
    """POST each result to the backend as JSON, 10 s timeout.

    Returns {video_name: bool}: True only for results the backend confirmed
    (HTTP 200/201), so callers can keep the others for a retry."""
    posted = {}
    for result in results:
        video_name = result["video_name"]
        posted[video_name] = False
        video_url = construct_url(video_name)
        if not video_url:
            print(f"Failed to construct URL for {video_name}")
            continue
        payload = {
            "url": video_url,
            "labels": result["labels"],
            "scores": result["scores"],
            "timestamp": result["timestamp"],
        }
        request = urllib.request.Request(
            backend_url, data=json.dumps(payload).encode(), method="POST",
            headers={"Content-Type": "application/json"},
        )
        try:
            try:
                with urllib.request.urlopen(request, timeout=10) as response:
                    status, text = response.status, response.read().decode(errors="replace")
            except urllib.error.HTTPError as e:  # a reply, with an error status
                status, text = e.code, e.read().decode(errors="replace")
            if status in (200, 201):
                posted[video_name] = True
                print(f"Successfully sent classification result to backend for {video_name}")
            else:
                print(
                    f"Failed to send classification result for {video_name}. "
                    f"HTTP {status}: {text}"
                )
        except (OSError, ValueError) as e:  # no connection, a timeout, a bad URL
            print(f"Error sending result to backend for {video_name}: {e}")
    return posted


def _load_with_device_sampling(videos_dir: str, sampling: str, seq_len: int, img_h: int,
                               img_w: int, device=None):
    """Decode every frame of each video on the host (uint8), then select
    and normalize on ``device`` (default: the card) through
    ``sample_decoded_clips``, one video at a time, each selected clip
    copied back to the host. Returns ((N, T, H, W, 3) float32 numpy clips,
    names); a file that fails to decode is reported and skipped."""
    from vct_torch.data import video
    from vct_torch.data.ingest import VIDEO_EXTS

    if sampling not in _DEVICE_METHODS:
        raise KeyError(
            f"Unknown sampling method {sampling!r} for --device_sampling; "
            f"available: {sorted(_DEVICE_METHODS)}"
        )
    dev = resolve_device(device)
    names, clips = [], []
    for fname in sorted(os.listdir(videos_dir)):
        if not fname.lower().endswith(VIDEO_EXTS):
            continue
        try:
            frames = video.decode_video(os.path.join(videos_dir, fname), img_h, img_w)
        except Exception as e:  # a bad file is skipped and reported, as in vct
            print(f"Error processing {fname}: {e}")
            continue
        if not frames:
            continue
        clip = sample_decoded_clips([np.stack(frames)], sampling, seq_len, device=dev)[0]
        clips.append(clip.cpu().numpy())
        names.append(fname)
    x = (np.stack(clips) if clips
         else np.zeros((0, seq_len, img_h, img_w, 3), np.float32))
    print(f"Final data shape: {x.shape}")
    return x, names


def serving_mesh(dev):
    """A data mesh over every visible device of ``dev``'s type (``vct``'s
    ``make_mesh(jax.devices(), model=1)``), or None where there is one."""
    devices = visible_devices(dev)
    if len(devices) < 2:
        return None
    mesh = make_mesh(devices, model=1)
    print(f"Sharding inference over {mesh.size} devices")
    return mesh


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="Batch video classification")
    parser.add_argument("--model", required=True,
                        help="vct_torch checkpoint directory or .vctaot artifact")
    parser.add_argument("--videos", default=None, help="directory of videos")
    parser.add_argument("--frames", default=None,
                        help="directory of extracted frame images for ONE clip")
    parser.add_argument("--sampling", default=None, help="override sampling method")
    parser.add_argument("--sequence_length", type=int, default=None)
    parser.add_argument("--batch_size", type=int, default=32)
    parser.add_argument("--post", action="store_true", help="POST results to backend")
    parser.add_argument("--backend_url", default=None)
    parser.add_argument("--mesh", action="store_true",
                        help="shard inference over every visible card (one card: no change)")
    parser.add_argument("--device_sampling", action="store_true",
                        help="select frames on the device (decode every frame on the "
                             "host, score and top-k select on the device)")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the card; 'cpu' to run on the CPU)")
    args = parser.parse_args(argv)
    if not args.videos and not args.frames:
        parser.error("one of --videos or --frames is required")
    dev = resolve_device(args.device)
    servable = None
    if os.path.isfile(args.model):
        # A .vctaot artifact: weights and forward in one file, no model zoo,
        # config or checkpoint restore in the serving path.
        from vct_torch.serve.aot import AotServable

        servable = AotServable.load(args.model, device=dev)
        if servable.device_sampling:
            parser.error(
                "this artifact bakes on-device sampling in (raw-input "
                "contract, AotServable.classify_raw); the deployment CLI "
                "feeds pre-sampled clips — export without --device_sampling"
            )
        model = cfg = None
        class_names = servable.class_names
        # The manifest records the training-time sampling, so artifact
        # serving preprocesses as the checkpoint path would.
        sampling = args.sampling or servable.sampling_method or "uniform"
        art_T = servable.input_shape[0]
        if args.sequence_length and args.sequence_length != art_T:
            print(f"--sequence_length {args.sequence_length} overridden to {art_T}: the "
                  f"artifact's programs are exported for T={art_T}")
        seq_len = art_T
        img_h, img_w = servable.input_shape[1], servable.input_shape[2]
        if args.mesh:
            print("--mesh is ignored for .vctaot artifacts; export with "
                  "--data_parallel to serve an artifact across cards")
    else:
        model, class_names, cfg = load_model(args.model, device=dev)
        sampling = args.sampling or cfg.data.sampling_method
        seq_len = args.sequence_length or cfg.data.sequence_length
        img_h, img_w = cfg.data.img_height, cfg.data.img_width
    if args.frames:
        from vct_torch.data.frames import preprocess_frames_dir

        clip = preprocess_frames_dir(args.frames, seq_len, img_h, img_w)
        probs = (servable.classify(clip) if servable is not None
                 else classify_videos(model, clip, batch_size=1, device=dev))
        print(f"Predicted class: {class_names[int(np.argmax(probs[0]))]}")
        return 0
    if args.device_sampling:
        clips, names = _load_with_device_sampling(args.videos, sampling, seq_len, img_h,
                                                  img_w, device=dev)
    else:
        from vct_torch.data.ingest import load_dataset_inference

        clips, names = load_dataset_inference(
            args.videos, sampling_method=sampling, sequence_length=seq_len,
            img_height=img_h, img_width=img_w,
        )
    if len(names) == 0:
        print("No videos found.")
        return 1
    mesh = serving_mesh(dev) if args.mesh and servable is None else None
    results = classify_and_display(
        model, clips, names, class_names, batch_size=args.batch_size, device=dev, mesh=mesh,
        probs=servable.classify(clips) if servable is not None else None)
    if args.post:
        if cfg is not None:
            backend_url = args.backend_url or cfg.serve.backend_url
        else:
            from vct_torch.core.config import ServeConfig

            backend_url = args.backend_url or ServeConfig().backend_url
        post_results(results, backend_url)
    return 0


if __name__ == "__main__":
    sys.exit(main())
