"""The out-of-core train/eval session (``data.stream=true``): the port of
``vct/train/stream.py``.

Ensure the dataset cache exists, split it by index, open a streaming loader
on each side, train and evaluate through the loader API, and always close
the loaders.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from vct_torch.core.config import Config
from vct_torch.core.metrics_contract import RunMetrics

__all__ = ["stream_train_eval"]


def stream_train_eval(cfg: Config, device=None) -> Tuple[object, RunMetrics]:
    """Train + evaluate streaming from the configured cache, on ``device``
    (default: the card). Returns (final TrainState, eval RunMetrics)."""
    from vct_torch.data.ingest import ensure_cache
    from vct_torch.data.loaders import cache_num_examples, open_cache_loader, split_indices
    from vct_torch.train.checkpoint import gather_state_dict, save_checkpoint
    from vct_torch.parallel.multihost import primary_first
    from vct_torch.train.engine import Trainer, compute_class_weights

    primary_first(ensure_cache, cfg)  # every rank of a world reads one cache
    class_names: List[str] = [
        str(c) for c in np.load(cfg.data.classes_file, allow_pickle=True)
    ]
    n = cache_num_examples(cfg)
    train_idx, test_idx = split_indices(n, cfg.data.val_fraction, cfg.data.split_seed)
    if len(train_idx) == 0:
        raise ValueError(
            f"empty train split: cache {cfg.data.data_file} has {n} clips and "
            f"data.val_fraction={cfg.data.val_fraction} leaves none for "
            "training"
        )
    loaders = []
    try:
        train_loader = open_cache_loader(cfg, train_idx)
        loaders.append(train_loader)
        test_loader = open_cache_loader(cfg, test_idx)
        loaders.append(test_loader)
        print(f"Train: {len(train_idx)} clips, Test: {len(test_idx)} clips "
              f"(streaming from {cfg.data.data_file}), classes: {class_names}")
        weights = None
        if cfg.train.weighted_loss:
            weights = compute_class_weights(
                train_loader.labels, cfg.model.num_classes, cfg.model.classif_mode,
            )
            print("class weights:", weights)
        trainer = Trainer(cfg, class_names, class_weights=weights, device=device)
        state = trainer.init_state()
        val = test_loader if (
            cfg.train.lr_plateau_factor or cfg.train.early_stop_patience
        ) else None
        state, run = trainer.fit(state, train_loader, val=val)
        if cfg.train.save_model:
            path = save_checkpoint(cfg.train.model_path, gather_state_dict(state), cfg,
                                   class_names)
            print(f"Model saved to {path}")
        metrics = trainer.evaluate(state, test_loader, run=run)
        return state, metrics
    finally:
        # Leaked h5py handles or memmaps of the shared cache would pile up
        # in a process that runs many sessions.
        for loader in loaders:
            loader.close()
