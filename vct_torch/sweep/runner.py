"""Sweep executor: the port of ``vct/sweep/runner.py``.

The reference's runner sed-patches ``all_config.py``, launches ``main.py`` as
a subprocess, and regex-scrapes seven metrics from its stdout
(``runner.py:9-135``). Here, as in ``vct``, the default is **in-process**:
overrides apply immutably to the Config, each trial builds its own
``Trainer``, model and optimizer on the runner's device (the card unless the
caller names another, through ``resolve_device``), and metrics come back as
structured values. ``use_subprocess=True`` launches ``python -m
vct_torch.train`` (with ``--device`` when the runner's device is not the
card) and scrapes its stdout with ``vct_torch.core.metrics_contract.
extract_metrics``; a trial with ``data.stream`` streams from the dataset
cache through ``vct_torch.train.stream.stream_train_eval``.

Kept semantics: per-config repeat runs with best-F1 selection, each run
seeded ``train.seed + run_idx`` (``runner.py:14,67``), a failed run logged
and skipped (``runner.py:57-64``), the F1 keep threshold (``runner.py:67``:
> ``sweep.f1_threshold``), best-model directories named by their config
(``runner.py:69-75``), and a journaled store append after every improvement
(``runner.py:82-96``).

Under a process group (``torchrun``, ``vct_torch.parallel.multihost``)
every rank runs the same sweep and each trial trains across the world's
ranks (the trainer's mesh). The strategies draw from their own seeded
generators and the trials' metrics are global, so every rank proposes the
same points; the store, its journal, the checkpoints and the best-model
directories are written by the primary alone, behind barriers. The
subprocess mode runs one process a trial and is refused under a world.

Not ported: ``vct``'s compiled-step cache between trials (``_trace_key``,
``_share_compiled_steps``). It reuses XLA's compiled train, eval and val
steps across trials whose traces agree. The port compiles nothing per trial:
its steps run eagerly, and the CUDA kernels are built once a process
(``vct_torch.ops._build``, cached by source hash).
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
from typing import Dict, List, Optional, Tuple

from vct_torch.core.config import Config
from vct_torch.core.metrics_contract import RunMetrics, extract_metrics
from vct_torch.device import resolve_device
from vct_torch.parallel import multihost
from vct_torch.sweep.store import SweepStore

__all__ = ["SweepRunner"]


class SweepRunner:
    def __init__(
        self,
        base_cfg: Config,
        store: Optional[SweepStore] = None,
        data: Optional[tuple] = None,
        use_subprocess: bool = False,
        device=None,
    ):
        self.world = multihost.process_count() > 1
        if self.world and use_subprocess:
            raise ValueError("use_subprocess starts one process a trial; under a world of "
                             "ranks the trials train in process, across the ranks")
        # Under a world each rank trains on the device initialize gave it.
        self.device = multihost.local_device() if self.world else resolve_device(device)
        self.base_cfg = base_cfg
        self.store = store or SweepStore(base_cfg.sweep.checkpoint_file)
        self._data = data  # optional preloaded (x, y, class_names)
        self.use_subprocess = use_subprocess
        self.best_results: List[dict] = self.store.load()

    # ------------------------------------------------------------------
    def _train_once(self, cfg: Config) -> RunMetrics:
        if self.use_subprocess:
            return self._train_subprocess(cfg)
        return self._train_inprocess(cfg)

    def _train_inprocess(self, cfg: Config) -> RunMetrics:
        from vct_torch.data.batcher import train_test_split
        from vct_torch.train.checkpoint import gather_state_dict, save_checkpoint
        from vct_torch.train.engine import Trainer, compute_class_weights

        if cfg.data.stream and not cfg.data.synthetic and self._data is None:
            # Out-of-core sweep: every trial streams from the shared cache.
            return self._train_inprocess_stream(cfg)
        if self._data is not None:
            x, y, class_names = self._data
        else:
            from vct_torch.train.__main__ import load_training_data

            x, y, class_names = load_training_data(cfg)
        x_tr, x_te, y_tr, y_te = train_test_split(
            x, y, cfg.data.val_fraction, cfg.data.split_seed
        )
        weights = None
        if cfg.train.weighted_loss:
            weights = compute_class_weights(
                y_tr, cfg.model.num_classes, cfg.model.classif_mode
            )
        trainer = Trainer(cfg, class_names, class_weights=weights, device=self.device)
        state = trainer.init_state()
        val = (x_te, y_te) if (
            cfg.train.lr_plateau_factor or cfg.train.early_stop_patience
        ) else None
        state, run = trainer.fit(state, x_tr, y_tr, val=val)
        if cfg.train.save_model:
            save_checkpoint(
                cfg.train.model_path, gather_state_dict(state), cfg, class_names
            )
        return trainer.evaluate(state, x_te, y_te, run=run)

    def _train_inprocess_stream(self, cfg: Config) -> RunMetrics:
        """Stream the trial from the dataset cache (built once, shared by
        every trial)."""
        from vct_torch.train.stream import stream_train_eval

        _, metrics = stream_train_eval(cfg, device=self.device)
        return metrics

    def _train_subprocess(self, cfg: Config) -> RunMetrics:
        args = [sys.executable, "-m", "vct_torch.train"]
        overrides = _diff_overrides(Config(), cfg)
        for key, value in overrides.items():
            args += [f"--{key}", str(value)]
        if str(self.device) != "cuda":
            args += ["--device", str(self.device)]
        proc = subprocess.run(args, capture_output=True, text=True)
        log_path = cfg.sweep.log_file
        os.makedirs(os.path.dirname(os.path.abspath(log_path)), exist_ok=True)
        with open(log_path, "a") as f:
            f.write(proc.stdout)
            if proc.stderr:
                f.write(f"Error Output:\n{proc.stderr}\n\n")
        return extract_metrics(proc.stdout)

    # ------------------------------------------------------------------
    def run_training(
        self, config: Dict, test_runs: Optional[int] = None
    ) -> Tuple[float, Optional[str]]:
        """Train ``config`` test_runs times; keep/record the best run.

        config: dotted-override dict, e.g. {"model.rnn_type": "lstm"}.
        Returns (best_f1, best_model_filename).
        """
        sweep = self.base_cfg.sweep
        test_runs = test_runs if test_runs is not None else sweep.test_runs
        best_f1 = -float("inf")
        best_model_filename = None

        for run_idx in range(test_runs):
            cfg = self.base_cfg.replace(**config)
            cfg = cfg.replace(**{"train.seed": str(cfg.train.seed + run_idx)})
            print(f"Applying config:\n{config}")
            try:
                metrics = self._train_once(cfg)
            except Exception as e:  # runner.py:57-64 logs and continues
                print(f"Error extracting metrics: {e}")
                continue
            print(
                f"Metrics: Accuracy={metrics.accuracy}, Precision={metrics.precision}, "
                f"Recall={metrics.recall}, F1={metrics.f1}, "
                f"Train Duration={metrics.training_duration}s, "
                f"Inference Duration={metrics.inference_duration}s"
            )
            if metrics.f1 > best_f1 and metrics.f1 > sweep.f1_threshold:
                best_f1 = metrics.f1
                best_model_filename = cfg.artifact_name("best_model")
                best_path = os.path.join(sweep.best_model_dir, best_model_filename)
                if (cfg.train.save_model and os.path.exists(cfg.train.model_path)
                        and multihost.is_primary()):
                    os.makedirs(sweep.best_model_dir, exist_ok=True)
                    if os.path.exists(best_path):
                        shutil.rmtree(best_path)
                    shutil.copytree(cfg.train.model_path, best_path)
                    print(f"Saving best model: {best_model_filename}")
                entry = {
                    "config": dict(config),
                    "metrics": metrics.to_dict(),
                    "best_model_filename": best_model_filename,
                }
                self.best_results.append(entry)
                if multihost.is_primary():
                    self.store.append(entry)
                multihost.barrier("sweep store")
            elif metrics.f1 > best_f1:
                best_f1 = metrics.f1
        return best_f1, best_model_filename

    def objective(self, config: Dict) -> float:
        """Single-run objective for strategy loops; returns F1 (records all)."""
        f1, _ = self.run_training(config, test_runs=1)
        return f1 if f1 != -float("inf") else 0.0


def _diff_overrides(base: Config, cfg: Config) -> Dict[str, str]:
    """Dotted overrides that transform base into cfg."""
    out = {}
    bd, cd = base.to_dict(), cfg.to_dict()
    for section, fields in cd.items():
        for key, value in fields.items():
            if bd[section][key] != value:
                out[f"{section}.{key}"] = value
    return out
