"""Ahead-of-time servable artifacts (``torch.export``): the port of
``vct/serve/aot.py``.

The reference serves from a whole serialized module (``torch.load(path)``
in ``medsos_lrcn/src/deployment.py:63``). This module writes the port's
counterpart: one ``.vctaot`` file per trained model, a zip of
``manifest.json`` and one ``batch_{b}.pt2`` per batch bucket, each the
``torch.export`` program of the softmax forward with the **weights inside**.
A server that loads the file classifies with no model zoo, no config and no
checkpoint restore in its path: it imports the port's kernel operators
(``vct_torch.ops``), which the programs call as ``torch.ops.vct_torch.*``
nodes, and nothing else of the model code.

With ``device_sampling`` the program also holds the serving pipeline's
front: frame scoring (the K1 or K4 kernel), top-T selection and /255 on
ragged raw uint8 clips (``device_sample_clips``). Caption artifacts hold the
captioner's encoder and the whole beam search, the vocabulary in the
manifest.

Artifacts are per platform: a program exported on the card holds its
weights there and calls the CUDA kernels, so it serves on the card, and one
exported on the CPU serves on the CPU. The manifest's ``format`` is
``vct-torch-aot-v1`` (``vct-torch-aot-caption-v1`` for captioners), so
neither package mistakes the other's file; a ``vct`` file (StableHLO for
JAX) is refused, naming the converter. ``data_parallel`` above 1 is not
ported (ROADMAP Queue 1 item 8).

Usage::

    python -m vct_torch.serve.aot --model /ckpt/run1 --out run1.vctaot --batches 1,32

    sv = AotServable.load("run1.vctaot")   # on the card; device="cpu" for the CPU
    probs = sv.classify(clips)             # (N, T, H, W, 3) float32 in [0, 1]
"""

from __future__ import annotations

import io
import json
import os
import warnings
import zipfile
from typing import List, Optional, Sequence, Tuple

import numpy as np

from vct_torch.device import resolve_device

__all__ = [
    "export_servable", "export_from_checkpoint", "AotServable",
    "export_caption_servable", "export_from_caption_checkpoint",
    "CaptionAotServable", "main",
]

_MANIFEST = "manifest.json"
_FORMAT = "vct-torch-aot-v1"
_CAPTION_FORMAT = "vct-torch-aot-caption-v1"
# vct's own artifacts: StableHLO for JAX, which the port cannot run.
_VCT_FORMATS = ("vct-aot-v1", "vct-aot-caption-v1")


def _register_ops() -> None:
    """Register the kernel operators the programs call (importing each
    module registers its operator; nothing is built)."""
    import vct_torch.ops.lstm  # noqa: F401
    import vct_torch.ops.pair_scores  # noqa: F401
    import vct_torch.ops.selective_scan  # noqa: F401
    import vct_torch.ops.ssim  # noqa: F401


def _check_data_parallel(n_dev: int) -> int:
    n_dev = int(n_dev)
    if n_dev < 1:
        raise ValueError(f"data_parallel must be >= 1, got {n_dev}")
    if n_dev > 1:
        raise NotImplementedError(
            f"data_parallel={n_dev}: artifacts served across several cards are not "
            "ported to vct_torch yet (ROADMAP Queue 1 item 8)"
        )
    return n_dev


def _make_stager(device):
    """Host chunk -> tensor on ``device``; shared by both servables."""
    import torch

    def stage(chunk):
        return torch.from_numpy(np.ascontiguousarray(chunk)).to(device)

    return stage


def _check_platform(platform: str, device) -> None:
    """Raise when an artifact was exported for another platform than the
    device asked for (a program holds its weights and kernels for the
    device it was exported on). Shared by both servable loaders."""
    here = device.type
    if platform.lower() != here.lower():
        raise ValueError(
            f"artifact was exported for platform={platform!r} but "
            f"the device here is {here!r}; re-export on this "
            "platform (python -m vct_torch.serve.aot)"
        )


def _bucket_for(buckets: List[int], n: int) -> int:
    """Smallest bucket that fits ``n`` rows, else the largest."""
    for b in buckets:
        if b >= n:
            return b
    return buckets[-1]


def _run_bucketed(fns, buckets, arrays, stage, empty):
    """Stream ``(array_0[i], array_1[i], ...)`` batches through the bucketed
    programs: full chunks use the largest bucket, the tail pads up to the
    smallest bucket that fits (the discipline of
    ``deployment.classify_videos``), padded rows are cut off on the host,
    and one chunk is on the device at a time.

    ``stage`` places one host chunk on the device; ``empty`` is the tuple of
    zero-row outputs returned for empty input. A program returns one tensor
    or a tuple; outputs concatenate per position."""
    import torch

    outs = tuple([] for _ in empty)
    big = buckets[-1]
    n = len(arrays[0])
    start = 0
    with torch.inference_mode():
        while start < n:
            chunks = [a[start : start + big] for a in arrays]
            m = len(chunks[0])
            b = _bucket_for(buckets, m)
            if m < b:
                chunks = [
                    np.concatenate([c, np.zeros((b - m,) + c.shape[1:], c.dtype)])
                    for c in chunks
                ]
            res = fns[b](*[stage(c) for c in chunks])
            if not isinstance(res, (tuple, list)):
                res = (res,)
            for acc, r in zip(outs, res):
                acc.append(r.cpu().numpy()[:m])
            del res  # free this chunk's outputs before the next one is staged
            start += m
    if not outs[0]:
        return empty
    return tuple(np.concatenate(acc) for acc in outs)


def _model_device(model):
    return next(model.parameters()).device


def _check_raw_len(raw_len, device_sampling, T: int, what: str) -> int:
    if raw_len is not None and not device_sampling:
        raise ValueError(
            "raw_len only applies with device_sampling (it sizes the raw "
            f"uint8 clip capacity the baked-in {what} selects from)"
        )
    raw_len = int(raw_len) if raw_len is not None else 2 * T
    if device_sampling and raw_len <= T:
        raise ValueError(f"raw_len {raw_len} must exceed the sampled T={T}")
    return raw_len


def _export_buckets(module, batch_sizes, input_shape, raw_len, raw: bool, device) -> dict:
    """``torch.export.save`` bytes of ``module`` per batch bucket, in eval
    mode under ``torch.no_grad``: (b, T, H, W, C) f32 clips, or (b, raw_len,
    H, W, C) uint8 clips and (b,) int32 lengths."""
    import torch

    blobs = {}
    module.eval()
    for b in sorted(set(int(b) for b in batch_sizes)):
        if b <= 0:
            raise ValueError(f"batch sizes must be positive, got {b}")
        if raw:
            args = (torch.zeros((b, raw_len) + tuple(input_shape[1:]), dtype=torch.uint8,
                                device=device),
                    torch.full((b,), raw_len, dtype=torch.int32, device=device))
        else:
            args = (torch.zeros((b,) + tuple(input_shape), dtype=torch.float32, device=device),)
        with torch.no_grad():
            program = torch.export.export(module, args, strict=False)
        # The example inputs (zeros) would be saved beside the weights: at
        # the served B=32 clips they outweigh them.
        program.example_inputs = None
        buf = io.BytesIO()
        with warnings.catch_warnings():
            # Channels-last conv weights are dense but not contiguous, which
            # the archive writer reports; it saves their whole storage.
            warnings.filterwarnings("ignore", message="No complete tensor found in the group")
            torch.export.save(program, buf)
        blobs[b] = buf.getvalue()
    return blobs


def _write(path: str, manifest: dict, blobs: dict) -> None:
    # The programs are zip archives themselves: stored, not compressed again.
    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED) as zf:
        zf.writestr(_MANIFEST, json.dumps(manifest, indent=2))
        for b, blob in blobs.items():
            zf.writestr(f"batch_{b}.pt2", blob)


def export_servable(
    model,
    class_names: Sequence[str],
    input_shape: Tuple[int, int, int, int],
    path: str,
    batch_sizes: Sequence[int] = (1, 32),
    data_parallel: int = 1,
    sampling_method: Optional[str] = None,
    device_sampling: Optional[str] = None,
    raw_len: Optional[int] = None,
) -> None:
    """Write ``softmax(model(x))`` for each batch bucket into one file.

    ``model`` carries its weights and its device (the artifact's platform);
    ``vct``'s signature takes ``variables`` beside a stateless module, the
    port's module holds them. ``input_shape`` is the per-clip (T, H, W, C)
    geometry. ``sampling_method`` records the frame sampling the model was
    trained with, so that artifact serving preprocesses as the checkpoint
    path would.

    ``device_sampling`` bakes the serving pipeline's front into the
    programs: they take ragged raw uint8 clips (B, raw_len, H, W, 3) plus
    true lengths (B,) int32 and run frame scoring, top-T selection and /255
    (``vct_torch.data.preprocess.device_sample_clips``) before the forward.
    Serve with ``AotServable.classify_raw``. ``raw_len`` defaults to 2T.
    """
    import torch

    T = int(input_shape[0])
    raw_len = _check_raw_len(raw_len, device_sampling, T, "sampler")
    n_dev = _check_data_parallel(data_parallel)
    if device_sampling:
        from vct_torch.data.preprocess import device_sample_clips

        class Forward(torch.nn.Module):
            def __init__(self):
                super().__init__()
                self.model = model

            def forward(self, raw, lengths):
                x = device_sample_clips(raw, T, method=device_sampling, lengths=lengths)
                return torch.softmax(self.model(x).to(torch.float32), dim=-1)

    else:

        class Forward(torch.nn.Module):
            def __init__(self):
                super().__init__()
                self.model = model

            def forward(self, x):
                return torch.softmax(self.model(x).to(torch.float32), dim=-1)

    device = _model_device(model)
    blobs = _export_buckets(Forward(), batch_sizes, input_shape, raw_len,
                            bool(device_sampling), device)
    manifest = {
        "format": _FORMAT,
        "class_names": list(class_names),
        "input_shape": list(input_shape),
        "batch_sizes": sorted(blobs),
        "n_devices": n_dev,
        "sampling_method": sampling_method,
        "device_sampling": device_sampling,
        "raw_len": raw_len if device_sampling else None,
        "platform": device.type,
        "torch_version": torch.__version__,
    }
    _write(path, manifest, blobs)


def export_from_checkpoint(
    model_dir: str,
    path: str,
    batch_sizes: Sequence[int] = (1, 32),
    data_parallel: int = 1,
    device_sampling: Optional[str] = None,
    raw_len: Optional[int] = None,
    device=None,
) -> None:
    """Build an artifact from a vct_torch checkpoint directory, exported on
    ``device`` (default: the card); geometry and ``sampling_method`` come
    from the checkpoint's config."""
    from vct_torch.serve.deployment import load_model

    _check_data_parallel(data_parallel)
    model, class_names, cfg = load_model(model_dir, device=resolve_device(device))
    export_servable(
        model,
        class_names,
        (cfg.data.sequence_length, cfg.data.img_height, cfg.data.img_width, 3),
        path,
        batch_sizes=batch_sizes,
        data_parallel=data_parallel,
        sampling_method=cfg.data.sampling_method,
        device_sampling=device_sampling,
        raw_len=raw_len,
    )


def export_caption_servable(
    model,
    vocab,
    input_shape: Tuple[int, int, int, int],
    path: str,
    batch_sizes: Sequence[int] = (1, 8),
    beam_width: int = 3,
    max_len: int = 30,
    device_sampling: bool = False,
    raw_len: Optional[int] = None,
    data_parallel: int = 1,
) -> None:
    """Write the whole captioning pipeline per batch bucket: CNN features,
    encoder and beam search (``vct_torch.caption.beam.beam_search``, its
    ``max_len`` steps unrolled), the weights inside, the vocabulary in the
    manifest. ``beam_width``/``max_len`` are baked in; export another
    artifact to change them. Every captioner family ``beam_search`` supports
    exports (S2VT, v1 LSTM/GRU, transformer).

    ``device_sampling=True`` bakes the caption pipeline's interval frame
    selection (stride ``true_len // T``, last-frame padding) in: the
    programs take ragged raw uint8 clips (B, raw_len, H, W, 3) plus true
    lengths (B,) and select and /255 on the device before the encoder;
    serve with ``CaptionAotServable.caption_raw``. ``raw_len`` defaults to
    2T.
    """
    import torch

    from vct_torch.caption.beam import beam_search

    if beam_width < 1:
        raise ValueError(f"beam_width must be >= 1, got {beam_width}")
    if max_len < 1:
        raise ValueError(f"max_len must be >= 1, got {max_len}")
    T = int(input_shape[0])
    raw_len = _check_raw_len(raw_len, device_sampling, T, "selection")
    n_dev = _check_data_parallel(data_parallel)

    if device_sampling:
        from vct_torch.data.preprocess import device_sample_clips

        class Forward(torch.nn.Module):
            def __init__(self):
                super().__init__()
                self.model = model

            def forward(self, raw, lengths):
                video = device_sample_clips(raw, T, method="uniform", lengths=lengths,
                                            short_pad="last")
                return beam_search(self.model, video, beam_width=beam_width, max_len=max_len)

    else:

        class Forward(torch.nn.Module):
            def __init__(self):
                super().__init__()
                self.model = model

            def forward(self, video):
                return beam_search(self.model, video, beam_width=beam_width, max_len=max_len)

    device = _model_device(model)
    blobs = _export_buckets(Forward(), batch_sizes, input_shape, raw_len,
                            bool(device_sampling), device)
    manifest = {
        "format": _CAPTION_FORMAT,
        "vocab": vocab.to_dict(),
        "input_shape": list(input_shape),
        "batch_sizes": sorted(blobs),
        "n_devices": n_dev,
        "beam_width": int(beam_width),
        "max_len": int(max_len),
        "start_token": 1,
        "end_token": 2,
        "pad_token": 0,
        "device_sampling": bool(device_sampling),
        "raw_len": raw_len if device_sampling else None,
        "platform": device.type,
        "torch_version": torch.__version__,
    }
    _write(path, manifest, blobs)


def export_from_caption_checkpoint(
    ckpt_dir: str,
    path: str,
    batch_sizes: Sequence[int] = (1, 8),
    beam_width: Optional[int] = None,
    max_len: Optional[int] = None,
    height: int = 224,
    width: int = 224,
    device_sampling: bool = False,
    raw_len: Optional[int] = None,
    data_parallel: int = 1,
    device=None,
) -> None:
    """Build a caption artifact from a vct_torch caption checkpoint, exported
    on ``device`` (default: the card). The manifest records config and
    vocabulary; ``height``/``width`` fix the frame geometry to bake in (the
    reference's caption pipeline is 224x224; ``CaptionConfig`` carries no
    image size). ``device_sampling``/``raw_len``: see
    ``export_caption_servable``."""
    from vct_torch.caption.train import restore_caption_trainer

    _check_data_parallel(data_parallel)
    trainer, state, cfg = restore_caption_trainer(ckpt_dir, device=resolve_device(device))
    export_caption_servable(
        state.model,
        trainer.vocab,
        (cfg.num_frames, height, width, 3),
        path,
        batch_sizes=batch_sizes,
        beam_width=beam_width if beam_width is not None else cfg.beam_width,
        max_len=max_len if max_len is not None else cfg.max_caption_len,
        device_sampling=device_sampling,
        raw_len=raw_len,
        data_parallel=data_parallel,
    )


def _read_artifact(path: str, fmt: str, other: str, other_loader: str, device):
    """(manifest, {bucket: program module}) of an artifact of format
    ``fmt`` on ``device``: the platform is checked before any program is
    loaded, and the kernel operators are registered first."""
    import torch

    try:
        zf = zipfile.ZipFile(path)
    except (zipfile.BadZipFile, IsADirectoryError) as e:
        raise ValueError(f"{path}: not a {fmt} artifact ({e})") from None
    with zf:
        try:
            manifest = json.loads(zf.read(_MANIFEST))
        except (KeyError, ValueError) as e:
            raise ValueError(f"{path}: not a {fmt} artifact ({e})") from None
        found = manifest.get("format") if isinstance(manifest, dict) else None
        if found == other:
            kind = "captioning" if other == _CAPTION_FORMAT else "classification"
            raise ValueError(f"{path} is a {kind} artifact — load it with {other_loader}")
        if found in _VCT_FORMATS:
            raise ValueError(
                f"{path} is a vct artifact (format={found!r}, StableHLO for JAX), which "
                "vct_torch cannot serve: convert its checkpoint with `python "
                "convert_vct_checkpoint.py SRC DST` and export it again with `python -m "
                "vct_torch.serve.aot`"
            )
        if found != fmt:
            raise ValueError(f"{path}: not a {fmt} artifact (format={found!r})")
        _check_data_parallel(manifest.get("n_devices", 1))
        _check_platform(manifest["platform"], device)
        _register_ops()
        fns = {b: torch.export.load(io.BytesIO(zf.read(f"batch_{b}.pt2"))).module()
               for b in manifest["batch_sizes"]}
    return manifest, fns


def _warmup_servable(sv, dense_fn, raw_fn) -> None:
    """Run every bucket once on zeros, through the servable's dense entry
    point (pre-sampled clips) or its raw one (ragged uint8 + lengths),
    whichever it was exported with."""
    for b in sv._buckets:
        if sv.device_sampling:
            raw = np.zeros((b, sv.raw_len) + tuple(sv.input_shape[1:]), np.uint8)
            raw_fn(raw, np.full((b,), sv.input_shape[0], np.int32))
        else:
            dense_fn(np.zeros((b,) + sv.input_shape, np.float32))


def _check_clips(clips, input_shape) -> np.ndarray:
    clips = np.asarray(clips, np.float32)
    if clips.ndim != 5 or clips.shape[1:] != input_shape:
        raise ValueError(f"expected (N,) + {input_shape}, got {clips.shape}")
    return clips


def _check_raw(raw, lengths, raw_len: int, input_shape) -> Tuple[np.ndarray, np.ndarray]:
    raw = np.asarray(raw)
    want = (raw_len,) + tuple(input_shape[1:])
    if raw.dtype != np.uint8 or raw.ndim != 5 or raw.shape[1:] != want:
        raise ValueError(f"expected (N,) + {want} uint8, got {raw.shape} {raw.dtype}")
    lengths = np.asarray(lengths, np.int32)
    if lengths.shape != (len(raw),):
        raise ValueError(f"lengths must be ({len(raw)},), got {lengths.shape}")
    # The program's gather clamps out-of-range frame indices, so a length
    # beyond raw_len would silently select padding frames instead of raising.
    if len(lengths) and (lengths.min() < 1 or lengths.max() > raw_len):
        raise ValueError(
            f"lengths must be in [1, raw_len={raw_len}], got range "
            f"[{lengths.min()}, {lengths.max()}] — truncate clips to the artifact's raw "
            "capacity before calling"
        )
    return raw, lengths


class AotServable:
    """A loaded artifact: the programs per bucket and the label manifest."""

    def __init__(self, manifest: dict, fns: dict, device):
        self.class_names: List[str] = list(manifest["class_names"])
        self.input_shape = tuple(manifest["input_shape"])
        self.platform: str = manifest["platform"]
        self.n_devices: int = int(manifest.get("n_devices", 1))
        self.sampling_method: Optional[str] = manifest.get("sampling_method")
        self.device_sampling: Optional[str] = manifest.get("device_sampling")
        self.raw_len: Optional[int] = manifest.get("raw_len")
        self.device = device
        self._fns = fns  # batch size -> the program's module
        self._buckets = sorted(fns)
        self._stage = _make_stager(device)

    @property
    def buckets(self) -> Tuple[int, ...]:
        """Batch buckets, ascending: callers feeding chunks should chunk by
        ``buckets[-1]`` (smaller chunks zero-pad up to a bucket)."""
        return tuple(self._buckets)

    @classmethod
    def load(cls, path: str, device=None) -> "AotServable":
        """Load on ``device`` (default: the card), which must be the
        artifact's platform."""
        device = resolve_device(device)
        manifest, fns = _read_artifact(path, _FORMAT, _CAPTION_FORMAT,
                                       "CaptionAotServable.load", device)
        return cls(manifest, fns, device)

    def _run_chunks(self, arrays: Tuple[np.ndarray, ...]) -> np.ndarray:
        (probs,) = _run_bucketed(
            self._fns, self._buckets, arrays, self._stage,
            empty=(np.zeros((0, len(self.class_names)), np.float32),),
        )
        return probs

    def warmup(self) -> None:
        """Run every bucket once on zeros, so the first request does not pay
        the one-time costs of a program's first run (the kernels' build and
        plans, cuDNN's choices). The queue worker calls this before binding
        its port."""
        _warmup_servable(self, self.classify, self.classify_raw)

    def classify(self, clips: np.ndarray) -> np.ndarray:
        """Softmax probabilities for pre-sampled (N, T, H, W, 3) f32 clips."""
        if self.device_sampling:
            raise ValueError(
                "this artifact bakes in on-device sampling — feed raw clips "
                "via classify_raw(raw, lengths)"
            )
        return self._run_chunks((_check_clips(clips, self.input_shape),))

    def classify_raw(self, raw: np.ndarray, lengths) -> np.ndarray:
        """Softmax probabilities straight from RAGGED RAW uint8 clips.

        ``raw`` is (N, raw_len, H, W, 3) uint8 (each clip's true frames
        first, tail padding ignored); ``lengths`` the true frame counts.
        Frame scoring, top-T selection, /255 and the forward all run inside
        the artifact's program."""
        if not self.device_sampling:
            raise ValueError(
                "this artifact has no baked-in sampling — feed sampled "
                "clips via classify(clips)"
            )
        return self._run_chunks(_check_raw(raw, lengths, self.raw_len, self.input_shape))


class CaptionAotServable:
    """A loaded captioning artifact: the beam-search programs per bucket and
    the vocabulary; clips in, word lists out, no model zoo in the path."""

    def __init__(self, manifest: dict, fns: dict, device):
        from vct_torch.caption.vocab import Vocabulary

        self.input_shape = tuple(manifest["input_shape"])
        self.platform: str = manifest["platform"]
        self.beam_width: int = int(manifest["beam_width"])
        self.max_len: int = int(manifest["max_len"])
        self.start_token: int = int(manifest["start_token"])
        self.end_token: int = int(manifest["end_token"])
        self.pad_token: int = int(manifest["pad_token"])
        self.device_sampling: bool = bool(manifest.get("device_sampling"))
        self.raw_len: Optional[int] = manifest.get("raw_len")
        self.n_devices: int = int(manifest.get("n_devices", 1))
        self.vocab = Vocabulary.from_dict(manifest["vocab"])
        self.device = device
        self._fns = fns
        self._buckets = sorted(fns)
        self._stage = _make_stager(device)

    @property
    def buckets(self) -> Tuple[int, ...]:
        """Batch buckets, ascending (see ``AotServable.buckets``)."""
        return tuple(self._buckets)

    @classmethod
    def load(cls, path: str, device=None) -> "CaptionAotServable":
        """Load on ``device`` (default: the card), which must be the
        artifact's platform."""
        device = resolve_device(device)
        manifest, fns = _read_artifact(path, _CAPTION_FORMAT, _FORMAT, "AotServable.load",
                                       device)
        return cls(manifest, fns, device)

    def _decode(self, arrays):
        tokens, scores = _run_bucketed(
            self._fns, self._buckets, arrays, self._stage,
            empty=(np.zeros((0, self.max_len + 1), np.int64), np.zeros((0,), np.float32)),
        )
        return tokens.astype(np.int32), scores

    def warmup(self) -> None:
        """Run every bucket once on zeros (see ``AotServable.warmup``)."""
        _warmup_servable(self, self.decode, self.decode_raw)

    def decode(self, clips: np.ndarray):
        """(tokens (N, max_len+1) int32 incl. the leading <start>, scores
        (N,)) for pre-sampled (N, T, H, W, 3) float32 clips in [0, 1]."""
        if self.device_sampling:
            raise ValueError(
                "this artifact bakes in on-device frame selection — feed "
                "raw clips via decode_raw/caption_raw(raw, lengths)"
            )
        return self._decode((_check_clips(clips, self.input_shape),))

    def decode_raw(self, raw: np.ndarray, lengths):
        """(tokens, scores) straight from RAGGED RAW uint8 clips: interval
        frame selection, /255, encoder and beam search all run inside the
        artifact's program."""
        if not self.device_sampling:
            raise ValueError(
                "this artifact has no baked-in frame selection — feed "
                "pre-sampled clips via decode/caption(clips)"
            )
        return self._decode(_check_raw(raw, lengths, self.raw_len, self.input_shape))

    def _words(self, tokens) -> List[List[str]]:
        from vct_torch.caption.beam import decode_tokens

        return [decode_tokens(row, self.vocab, self.start_token, self.end_token,
                              self.pad_token)
                for row in tokens]

    def caption(self, clips: np.ndarray) -> List[List[str]]:
        """Word lists for (N, T, H, W, 3) float32 clips in [0, 1]."""
        tokens, _ = self.decode(clips)
        return self._words(tokens)

    def caption_raw(self, raw: np.ndarray, lengths) -> List[List[str]]:
        """Word lists straight from ragged raw uint8 clips (see decode_raw)."""
        tokens, _ = self.decode_raw(raw, lengths)
        return self._words(tokens)


def _written_manifest(path: str) -> dict:
    """The manifest of an artifact just written. The CLI prints ``vct``'s
    line from it; ``vct`` loads the artifact to print it, which here would
    take about as long as the export (each program's graph and weights)."""
    with zipfile.ZipFile(path) as zf:
        return json.loads(zf.read(_MANIFEST))


def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    parser = argparse.ArgumentParser(
        description="Export an AOT servable artifact from a checkpoint"
    )
    parser.add_argument("--model", required=True, help="checkpoint directory")
    parser.add_argument("--out", required=True, help="artifact output path")
    parser.add_argument(
        "--batches", default=None,
        help="comma-separated batch buckets to export (default 1,32 for "
             "classifier checkpoints; 1,8 for caption checkpoints — beam "
             "search per row is far heavier than one classifier forward)",
    )
    parser.add_argument(
        "--data_parallel", type=int, default=1,
        help="cards to serve across (only 1 is ported; ROADMAP Queue 1 item 8)",
    )
    parser.add_argument(
        "--device_sampling", default=None,
        help="bake on-device frame selection into the programs: they "
             "then take ragged raw uint8 clips + lengths. Classifier "
             "checkpoints: sad|ssim|uniform|flow "
             "(AotServable.classify_raw); caption checkpoints: interval "
             "(CaptionAotServable.caption_raw)",
    )
    parser.add_argument(
        "--raw_len", type=int, default=None,
        help="raw frame capacity per clip for --device_sampling "
             "(default 2x the model's T)",
    )
    parser.add_argument(
        "--beam_width", type=int, default=None,
        help="caption checkpoints only: beam width to bake in "
             "(default: the checkpoint config's)",
    )
    parser.add_argument(
        "--max_len", type=int, default=None,
        help="caption checkpoints only: max caption length to bake in",
    )
    parser.add_argument(
        "--height", type=int, default=None,
        help="caption checkpoints only: frame height to bake in "
             "(default 224 — the reference caption pipeline)",
    )
    parser.add_argument(
        "--width", type=int, default=None,
        help="caption checkpoints only: frame width to bake in",
    )
    parser.add_argument("--device", default=None,
                        help="torch device to export on and for (default: the card; "
                             "'cpu' for a CPU artifact)")
    args = parser.parse_args(argv)

    # A caption checkpoint manifest carries the vocab; a classifier one
    # carries class_names — dispatch on that, no flag needed.
    manifest_path = os.path.join(args.model, _MANIFEST)
    is_caption = False
    if os.path.isfile(manifest_path):
        with open(manifest_path) as f:
            is_caption = "vocab" in json.load(f)

    if args.batches is None:
        args.batches = "1,8" if is_caption else "1,32"
    batch_sizes = [int(b) for b in args.batches.split(",") if b.strip()]

    if is_caption:
        if args.device_sampling not in (None, "interval"):
            parser.error(
                "caption artifacts support --device_sampling interval only "
                "(the caption pipeline's stride selection, "
                "s2vt/beam_search.py:143-180); sad/ssim/uniform/flow are "
                "classifier selection methods"
            )
        if args.raw_len is not None and not args.device_sampling:
            parser.error("--raw_len requires --device_sampling (it sizes "
                         "the raw clip capacity the baked-in selection "
                         "samples from)")
        export_from_caption_checkpoint(
            args.model, args.out, batch_sizes=batch_sizes,
            beam_width=args.beam_width, max_len=args.max_len,
            height=args.height if args.height is not None else 224,
            width=args.width if args.width is not None else 224,
            device_sampling=args.device_sampling == "interval",
            raw_len=args.raw_len,
            data_parallel=args.data_parallel,
            device=args.device,
        )
        m = _written_manifest(args.out)
        print(
            f"exported {args.out}: caption platform={m['platform']} "
            f"buckets={m['batch_sizes']} beam_width={m['beam_width']} "
            f"max_len={m['max_len']} "
            + (f"device_sampling=interval raw_len={m['raw_len']} "
               if m["device_sampling"] else "")
            + f"vocab={len(m['vocab']['word2idx'])} words"
        )
        return 0

    for flag, val in (("--beam_width", args.beam_width),
                      ("--max_len", args.max_len),
                      ("--height", args.height), ("--width", args.width)):
        if val is not None:
            parser.error(f"{flag} applies to caption checkpoints only "
                         "(classifier geometry comes from the checkpoint "
                         "config)")
    if args.raw_len is not None and not args.device_sampling:
        parser.error("--raw_len requires --device_sampling (it sizes the "
                     "raw clip capacity the baked-in sampler selects from)")
    export_from_checkpoint(args.model, args.out, batch_sizes=batch_sizes,
                           data_parallel=args.data_parallel,
                           device_sampling=args.device_sampling,
                           raw_len=args.raw_len, device=args.device)
    m = _written_manifest(args.out)
    print(
        f"exported {args.out}: platform={m['platform']} "
        f"buckets={m['batch_sizes']} devices={m['n_devices']} "
        + (f"device_sampling={m['device_sampling']} raw_len={m['raw_len']} "
           if m["device_sampling"] else "")
        + f"classes={m['class_names']}"
    )
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
