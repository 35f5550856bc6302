"""Training entry point: ``python -m vct_torch.train [--config file]
[--device cpu] [--a.b v ...]``, the port of ``vct/train/__main__.py``.

Load the dataset (``--data.synthetic true``, or a class-directory dataset
at ``--data.dataset_path`` decoded into the configured cache by
``load_or_build_dataset``), split it, build the model on the card (or on
``--device``), train with the configured loss, save the checkpoint and print
the reference-compatible metric block. With ``--data.stream true`` the
batches stream out of the cache (``vct_torch.train.stream``).

Under ``torchrun`` (``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK`` /
``MASTER_ADDR`` / ``MASTER_PORT`` in the environment) every process joins
the world (``vct_torch.parallel.multihost.initialize``: rank ``r`` on
``cuda:LOCAL_RANK`` over NCCL, or on the CPU over gloo with ``--device
cpu``) and trains one rank of a (``--mesh.data_axis``, ``--mesh.model_axis``)
mesh; only the primary prints and writes. Without ``torchrun`` it is one
process on one device::

    torchrun --nproc_per_node 4 -m vct_torch.train --data.synthetic true --mesh.model_axis 2
"""

from __future__ import annotations

import sys

from vct_torch.core.config import Config, load_config, parse_cli_overrides
from vct_torch.data.batcher import train_test_split
from vct_torch.data.synthetic import generate_dummy_data
from vct_torch.parallel import multihost
from vct_torch.train.checkpoint import gather_state_dict, save_checkpoint
from vct_torch.train.engine import Trainer, compute_class_weights


def load_training_data(cfg: Config):
    """Returns (x, y, class_names)."""
    if cfg.data.synthetic:
        return generate_dummy_data(
            num_samples=cfg.data.synthetic_samples,
            sequence_length=cfg.data.sequence_length,
            height=cfg.data.img_height,
            width=cfg.data.img_width,
            num_classes=cfg.model.num_classes,
            classif_mode=cfg.model.classif_mode,
            seed=cfg.train.seed,
        )
    from vct_torch.data.ingest import load_or_build_dataset

    # Every rank of a world reads the cache the primary builds.
    return multihost.primary_first(load_or_build_dataset, cfg)


def _pop_option(argv: list, name: str):
    """Remove ``name VALUE`` from argv; return VALUE (None if absent)."""
    if name not in argv:
        return None
    i = argv.index(name)
    if i + 1 >= len(argv):
        raise SystemExit(f"{name} requires an argument")
    value = argv[i + 1]
    del argv[i : i + 2]
    return value


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    config_path = _pop_option(argv, "--config")
    device = _pop_option(argv, "--device")  # default: the card
    cfg = load_config(config_path, parse_cli_overrides(argv))
    world = multihost._env_int("WORLD_SIZE", 1)
    if world > 1:
        multihost.initialize(device=device)
        device = multihost.local_device()
    try:
        return _train(cfg, device)
    finally:
        if world > 1:
            multihost.shutdown()


def _train(cfg: Config, device) -> int:
    say = print if multihost.is_primary() else (lambda *a, **k: None)
    if cfg.data.stream and not cfg.data.synthetic:
        from vct_torch.train.stream import stream_train_eval

        stream_train_eval(cfg, device=device)
        return 0

    x, y, class_names = load_training_data(cfg)
    x_train, x_test, y_train, y_test = train_test_split(
        x, y, cfg.data.val_fraction, cfg.data.split_seed
    )
    say(f"Train: {x_train.shape}, Test: {x_test.shape}, classes: {class_names}")

    weights = None
    if cfg.train.weighted_loss:
        weights = compute_class_weights(y_train, cfg.model.num_classes, cfg.model.classif_mode)
        say("class weights:", weights)

    trainer = Trainer(cfg, class_names, class_weights=weights, device=device)
    state = trainer.init_state()
    # The held-out split drives the plateau scheduler and the patience stop.
    val = (x_test, y_test) if (
        cfg.train.lr_plateau_factor or cfg.train.early_stop_patience
    ) else None
    state, run = trainer.fit(state, x_train, y_train, val=val)
    if cfg.train.save_model:
        path = save_checkpoint(cfg.train.model_path, gather_state_dict(state), cfg,
                               class_names)
        say(f"Model saved to {path}")
    trainer.evaluate(state, x_test, y_test, run=run)
    return 0


if __name__ == "__main__":
    sys.exit(main())
