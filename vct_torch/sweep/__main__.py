"""Sweep entry point: ``python -m vct_torch.sweep --strategy grid --space
space.json [--config cfg.json] [--device cpu] [--a.b v ...]``, the port of
``vct/sweep/__main__.py``.

The counterpart of ``hyperparam.py:226-236`` strategy dispatch. The space
file maps dotted config keys to choice lists or distributions (see
``vct_torch.sweep.space``). Base-config overrides pass through like
``vct_torch.train``'s; trials run on the card unless ``--device`` names
another device. ``vct``'s persistent XLA compile cache has no counterpart:
the port compiles nothing per trial.

Under ``torchrun`` every process joins the world (as ``python -m
vct_torch.train`` does) and each trial trains across the ranks. The
strategies are ``vct``'s copies and write their journals themselves, so a
rank other than the primary runs its strategy on a private copy of the
journal (made before any rank writes): every rank reads the same history
back, and only the primary writes the shared files.
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import tempfile

from vct_torch.core.config import load_config, parse_cli_overrides
from vct_torch.parallel import multihost
from vct_torch.sweep.runner import SweepRunner
from vct_torch.sweep.store import SweepStore
from vct_torch.sweep.strategies import STRATEGIES


def _journal(path: str, private: str) -> str:
    """The journal a strategy of this rank writes: ``path`` on the primary,
    a copy of it under ``private`` on the other ranks."""
    if multihost.is_primary():
        return path
    mine = os.path.join(private, os.path.basename(path))
    if os.path.exists(path):
        shutil.copy(path, mine)
    return mine


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)

    def grab(flag, default=None):
        if flag in argv:
            i = argv.index(flag)
            value = argv[i + 1]
            del argv[i : i + 2]
            return value
        return default

    strategy = grab("--strategy", "grid")
    space_path = grab("--space")
    config_path = grab("--config")
    device = grab("--device")  # default: the card
    if space_path is None:
        print("usage: python -m vct_torch.sweep --strategy {grid|bayesian|genetic} "
              "--space space.json [--config cfg.json] [--device cpu] [--a.b v ...]")
        return 2
    with open(space_path) as f:
        space = json.load(f)
    cfg = load_config(config_path, parse_cli_overrides(argv))
    world = multihost._env_int("WORLD_SIZE", 1) > 1
    if world:
        multihost.initialize(device=device)
    try:
        with tempfile.TemporaryDirectory(prefix="vct_sweep_rank_") as private:
            return _sweep(cfg, strategy, space, device, private)
    finally:
        if world:
            multihost.shutdown()


def _sweep(cfg, strategy: str, space: dict, device, private: str) -> int:
    runner = SweepRunner(cfg, store=SweepStore(cfg.sweep.checkpoint_file), device=device)
    journal_dir = os.path.dirname(runner.store.path) or "."
    trials = _journal(os.path.join(journal_dir, "bayes_trials.json"), private)
    generations = _journal(os.path.join(journal_dir, "genetic_checkpoint.json"), private)
    multihost.barrier("journals read")
    if strategy == "grid":
        best = STRATEGIES["grid"](runner, space)
    elif strategy == "bayesian":
        best = STRATEGIES["bayesian"](
            runner, space, n_trials=cfg.sweep.n_trials, seed=cfg.train.seed,
            trials_path=trials,
        )
    elif strategy == "genetic":
        best = STRATEGIES["genetic"](
            runner, space,
            population_size=cfg.sweep.population,
            generations=cfg.sweep.generations,
            cx_prob=cfg.sweep.cx_prob,
            mut_prob=cfg.sweep.mut_prob,
            seed=cfg.train.seed,
            checkpoint_path=generations,
        )
    else:
        print(f"Unknown strategy: {strategy}. Available: {sorted(STRATEGIES)}")
        return 2
    # Fold the O(1) append journal into the canonical reference-schema JSON
    # so the sweep's final artifact is one self-contained list.
    if multihost.is_primary():
        runner.store.compact()
    if multihost.is_primary():
        print("Best result:", json.dumps(best, indent=2) if best else None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
