"""Sweep-at-scale rehearsal on the card: the port of
``vct/tools/sweep_rehearsal.py``, a 24-trial TPE sweep end to end.

The reference's de-facto sweep benchmark is a 664-entry checkpoint store
grown by many-trial Optuna runs (``dumps/medsos_checkpoint.json``,
``hyperparam.py``). This script rehearses the production flow at tens of
trials:

  motion dataset -> real ingest (cv2 + the clip cache) -> SweepRunner
  (in-process, ``train.feature_cache``) -> TPE (``bayesian_optimization``,
  JSONL trials journal) -> SweepStore JSONL journal -> explicit compaction
  into the reference-schema canonical JSON -> best checkpoint directory
  named by its config.

The differences from ``vct``'s: the cache is ``data.cache_format
clipcache``, built and read by ``load_or_build_dataset`` (the card's machine
has no h5py for ``vct``'s HDF5 cache); ``--out`` defaults to a new temporary
directory; ``--scan_impl`` (default ``pallas``) sets ``model.scan_impl``, so
the trials' LSTM runs the hand-written K2 kernel forward and backward, where
``vct``'s rehearsal leaves the scan at ``associative``; ``--device cpu`` runs
on the CPU; the summary names the ``device`` in place of ``vct``'s
``backend``.

Run:  python -m vct_torch.tools.sweep_rehearsal [--trials 24] [--epochs 15]
          [--out DIR] [--scan_impl pallas] [--device cpu]
It prints the head kernels' launches over the sweep (none on the CPU), then
one JSON summary line last, which it also writes to ``summary.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time


# The TPE space: the learning rate on a log scale and the batch size.
SPACE = {
    "train.learning_rate": {"type": "float", "low": 3e-4, "high": 1e-2, "log": True},
    "train.batch_size": [8, 16],
}


def rehearsal_config(out: str, epochs: int, scan_impl: str = "pallas"):
    """The rehearsal's base Config: the motion dataset under ``out/videos``,
    its clip cache under ``out/cache``, a 2-layer LSTM on resnet18 at 64x64,
    T=4, with the feature cache, and the sweep's files under ``out``."""
    from vct_torch.core.config import Config

    return Config().replace(**{
        "data.dataset_path": os.path.join(out, "videos"),
        "data.processed_data_path": os.path.join(out, "cache"),
        "data.cache_format": "clipcache",
        "data.img_height": "64", "data.img_width": "64",
        "data.sequence_length": "4",
        "data.decode_workers": "0",
        "model.num_classes": "4",
        "model.rnn_input_size": "32",
        "model.mult_factor": "2",
        "model.cnn_backbone": "resnet18",
        "model.rnn_type": "lstm",
        "model.rnn_layer": "2",
        "model.rnn_out": "all",
        "model.dropout": "0.0",
        "model.scan_impl": scan_impl,
        "train.batch_size": "8",
        "train.optimizer": "adam",
        "train.grad_clip": "0",
        "train.epochs": str(epochs),
        "train.early_stop_patience": "0",
        "train.feature_cache": "true",
        "train.weighted_loss": "true",
        "train.save_model": "true",
        "train.model_path": os.path.join(out, "trial_model"),
        "sweep.checkpoint_file": os.path.join(out, "checkpoint.json"),
        "sweep.best_model_dir": os.path.join(out, "best_models"),
        "sweep.log_file": os.path.join(out, "sweep.log"),
    })


def _kernel_counters() -> dict:
    """The launch counters of the head's kernels (K2/K5, K3), forward and
    backward: they count launches on the card only."""
    from vct_torch.ops import lstm, selective_scan

    names = ("lstm_stack", "gru_stack", "lstm_scan", "gru_scan")
    return {**{n: getattr(lstm, n) for n in names},
            **{f"{n}_bwd": getattr(lstm, f"{n}_bwd") for n in names},
            "selective_scan": selective_scan.selective_scan,
            "selective_scan_bwd": selective_scan.selective_scan_bwd}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--trials", type=int, default=24)
    ap.add_argument("--epochs", type=int, default=15)
    ap.add_argument("--out", default=None,
                    help="working directory (default: a new temporary directory)")
    ap.add_argument("--scan_impl", default="pallas",
                    help="model.scan_impl of every trial (pallas: the K2 kernel)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' to run on the CPU)")
    args = ap.parse_args(argv)

    from vct_torch.data.ingest import load_or_build_dataset
    from vct_torch.data.synthetic import generate_motion_dataset
    from vct_torch.device import resolve_device
    from vct_torch.sweep.runner import SweepRunner
    from vct_torch.sweep.store import SweepStore
    from vct_torch.sweep.strategies import bayesian_optimization

    device = resolve_device(args.device)  # before any work: no card, no fallback
    out = args.out or tempfile.mkdtemp(prefix="vct_sweep_rehearsal_")
    os.makedirs(out, exist_ok=True)
    cfg = rehearsal_config(out, args.epochs, args.scan_impl)
    if not os.path.exists(cfg.data.dataset_path):
        generate_motion_dataset(
            cfg.data.dataset_path, clips_per_class=(16, 13, 13, 10), frames=16, size=64,
            seed=0,
        )
    x, y, names = load_or_build_dataset(cfg)
    store = SweepStore(cfg.sweep.checkpoint_file)
    print(f"dataset: {x.shape} on device={device}")
    runner = SweepRunner(cfg, store=store, data=(x, y, names), device=device)

    counters = _kernel_counters()
    before = {name: fn.launches for name, fn in counters.items()}
    t0 = time.time()
    best = bayesian_optimization(
        runner, SPACE, n_trials=args.trials, n_warmup=8, seed=0,
        trials_path=os.path.join(out, "tpe_trials.json"),
    )
    wall = time.time() - t0
    launches = {name: fn.launches - before[name] for name, fn in counters.items()}
    print("kernel launches:", json.dumps({k: v for k, v in launches.items() if v}))
    journal_lines = 0
    if os.path.exists(store.journal_path):
        with open(store.journal_path) as f:
            journal_lines = sum(1 for line in f if line.strip())
    store.compact()  # fold the JSONL journal into the canonical JSON
    with open(store.path) as f:
        canonical = json.load(f)
    summary = {
        "trials": args.trials,
        "wall_s": round(wall, 1),
        "s_per_trial": round(wall / args.trials, 2),
        "best_f1": best["metrics"]["f1_score"] if best else None,
        "best_model": best.get("best_model_filename") if best else None,
        "store_entries": len(canonical),
        "journal_lines_before_compaction": journal_lines,
        "device": str(device),
    }
    print(json.dumps(summary))
    with open(os.path.join(out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    return summary


if __name__ == "__main__":
    main()
