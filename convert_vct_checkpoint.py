#!/usr/bin/env python3
"""Convert a ``vct`` (JAX, Orbax) checkpoint directory into a ``vct_torch`` one.

    python convert_vct_checkpoint.py SRC DST

Run it where ``vct`` runs (jax, flax and orbax import), on the CPU; copy DST
to the machine with the card, which needs neither. SRC is read through
``vct``'s own loaders, and every form found there is converted:

- a model checkpoint (``params/`` and a ``manifest.json`` that says
  ``"framework": "vct"``, ``vct.train.checkpoint.save_checkpoint``) becomes
  ``weights.pt`` and a ``vct_torch`` manifest with the same config, class
  names and metrics, which ``vct_torch.serve.deployment.load_model`` and
  ``train.init_from`` read;
- a train state (``train_state/`` and ``train_manifest.json``,
  ``vct.train.checkpoint.save_train_state``) becomes ``train_state.pt`` and
  a ``vct_torch`` train manifest, which ``train.resume`` continues from: the
  parameters, Adam's or AdamW's moments (optax's ``mu``, ``nu``, ``count``
  as torch's ``exp_avg``, ``exp_avg_sq``, ``step``, by parameter name), the
  plateau-lowered learning rate, the completed epochs and the trainer's
  counters;
- a caption checkpoint (``state/`` and a ``manifest.json`` with ``vocab``
  and ``config``, ``vct.caption.train.CaptionTrainer.save_checkpoint``)
  becomes ``caption_state.pt`` and a ``vct_torch`` manifest, which
  ``vct_torch.caption.train.restore_caption_trainer`` and a resumed caption
  ``fit`` read: parameters, Adam's moments, step (Adam's count where a
  legacy tree saved none), epoch, loss, the epoch history, vocab and config.

``vct``'s dropout key has no torch counterpart, so a converted train state
carries no dropout generator: a resumed run warns and draws its dropout
masks from the port's seed. Nothing is written unless every tensor maps
(``vct_torch.bridge.load_vct_variables`` is strict). SRC must hold at least
one of the three forms and no ``vct_torch`` manifest, and DST must be
another directory.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import os
import sys
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

def _read_json(path: str) -> Optional[dict]:
    if not os.path.isfile(path):
        return None
    with open(path) as f:
        return json.load(f)


def find_forms(src: str) -> List[str]:
    """The checkpoint forms SRC holds ("model", "train_state", "caption").
    Raises
    ``ValueError`` where SRC holds none, or a manifest ``vct_torch`` wrote."""
    manifest = _read_json(os.path.join(src, "manifest.json"))
    train_manifest = _read_json(os.path.join(src, "train_manifest.json"))
    for name, m in (("manifest.json", manifest), ("train_manifest.json", train_manifest)):
        if m is not None and m.get("framework") == "vct_torch":
            raise ValueError(f"{src}: {name} was written by vct_torch; there is nothing to "
                             "convert")
    forms = []
    if manifest is not None and manifest.get("framework") == "vct" \
            and os.path.isdir(os.path.join(src, "params")):
        forms.append("model")
    if train_manifest is not None:
        forms.append("train_state")
    if manifest is not None and "framework" not in manifest and "vocab" in manifest \
            and "config" in manifest and os.path.isdir(os.path.join(src, "state")):
        forms.append("caption")
    if not forms:
        raise ValueError(f"{src} holds no vct checkpoint: expected params/ with a vct "
                         "manifest.json, train_state/ with train_manifest.json, or a caption "
                         "checkpoint's state/ with a manifest.json holding vocab and config")
    return forms


# ---------------------------------------------------------------------------
# optax state -> torch.optim state


def _adam_state(opt_state):
    """The one ``ScaleByAdamState`` of a vct optimizer state, or None (sgd)."""
    import jax
    import optax

    found = [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    if len(found) > 1:
        raise ValueError(f"the optimizer state holds {len(found)} Adam states, not one")
    return found[0] if found else None


def _fill_masked(moment, params):
    """``moment`` as a full params-shaped tree: the subtrees optax masked out
    (the frozen backbone under ``set_to_zero``) filled with NaN, so a
    trained parameter that found no moment shows."""
    import optax

    if isinstance(moment, optax.MaskedNode):
        import jax

        return jax.tree_util.tree_map(lambda p: np.full(np.shape(p), np.nan, np.float32),
                                      params)
    if isinstance(moment, dict):
        return {k: _fill_masked(moment[k], params[k]) for k in params}
    return np.asarray(moment)


def _by_name(model, tree, params, extra_vars) -> Dict[str, "torch.Tensor"]:
    """A params-shaped tree (Adam's ``mu`` or ``nu``) in the port's layout,
    by parameter name: the bridge's transposes applied to a copy of
    ``model``."""
    from vct_torch.bridge import load_vct_variables

    clone = copy.deepcopy(model)
    load_vct_variables(clone, {"params": _fill_masked(tree, params), **extra_vars})
    return {n: p.detach().clone() for n, p in clone.named_parameters()}


def _load_optimizer(state, trained, model, opt_state, params, extra_vars,
                    learning_rate: float) -> int:
    """Fill the port's ``state.optimizer`` from vct's ``opt_state``: Adam's
    moments and count for each trained parameter (in ``trained``'s order,
    matched by name), and the learning rate into every param group. Returns
    Adam's count (0 without Adam)."""
    import torch

    adam = _adam_state(opt_state)
    count = 0
    if adam is not None:
        count = int(np.asarray(adam.count))
        mu = _by_name(model, adam.mu, params, extra_vars)
        nu = _by_name(model, adam.nu, params, extra_vars)
        names = {id(p): n for n, p in model.named_parameters()}
        for p in trained:
            name = names[id(p)]
            if bool(torch.isnan(mu[name]).any() or torch.isnan(nu[name]).any()):
                raise ValueError(f"{name} trains in vct_torch but has no Adam moments in the "
                                 "vct state (its freezing differs)")
            state.optimizer.state[p] = {
                "step": torch.tensor(float(count), dtype=torch.float32),
                # The parameter's own layout, as Adam's zeros_like would give.
                "exp_avg": torch.empty_like(p).copy_(mu[name]),
                "exp_avg_sq": torch.empty_like(p).copy_(nu[name]),
            }
    for group in state.optimizer.param_groups:
        group["lr"] = learning_rate
    return count


def _learning_rate(opt_state, default: float) -> float:
    """The learning rate ``inject_hyperparams`` keeps in the state (lowered
    by the plateau scheduler), else ``default``."""
    import optax.tree_utils as otu

    lr = otu.tree_get(opt_state, "learning_rate")
    return default if lr is None else float(np.asarray(lr))


# ---------------------------------------------------------------------------
# the three forms


def convert_model(src: str) -> Callable[[str], None]:
    """Read a vct model checkpoint; returns the writer of its vct_torch form."""
    from vct.train.checkpoint import load_checkpoint
    from vct_torch.bridge import load_vct_variables
    from vct_torch.core.config import Config
    from vct_torch.models import build_model
    from vct_torch.train.checkpoint import save_checkpoint

    variables, _, class_names, manifest = load_checkpoint(src)
    cfg = Config.from_dict(manifest["config"])
    model = build_model(cfg.model, cfg.data.sequence_length, device="cpu",
                        frame_size=(cfg.data.img_height, cfg.data.img_width))
    load_vct_variables(model, variables)
    print(f"model checkpoint: {len(model.state_dict())} tensors of "
          f"{cfg.model.model_family} into the port's layout")
    return lambda dst: save_checkpoint(dst, model.state_dict(), cfg, class_names,
                                       manifest.get("metrics"))


def convert_train_state(src: str) -> Callable[[str], None]:
    """Read a vct train state into a fresh vct trainer's state built from its
    manifest's config; returns the writer of its vct_torch form."""
    import jax

    from vct.core.config import Config as VctConfig
    from vct.train import engine as vct_engine
    from vct.train.checkpoint import load_train_state
    from vct_torch.bridge import load_vct_variables
    from vct_torch.core.config import Config
    from vct_torch.train import engine
    from vct_torch.train.checkpoint import save_train_state

    manifest = _read_json(os.path.join(src, "train_manifest.json"))
    # The template reads no files: warm starts and backbone weights are the
    # saved state's business.
    blank = {"train.init_from": "", "model.backbone_weights": ""}
    vcfg = VctConfig.from_dict(manifest["config"]).replace(**blank)
    trainer_v = vct_engine.Trainer(vcfg, manifest["class_names"])
    d = vcfg.data
    sample = np.zeros((1, d.sequence_length, d.img_height, d.img_width, 3), np.float32)
    # Only the tree's structure, shapes and dtypes matter (the restore fills
    # every leaf): traced, not run, since an eager Flax init compiles each
    # op (about 27 s for resnet18 on a CPU).
    shapes = jax.eval_shape(trainer_v.init_state, jax.random.PRNGKey(0), sample)
    template = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    state_v, epoch, extra = load_train_state(src, template)
    if epoch == 0:
        raise ValueError(f"{src}: vct could not restore its train state (see the warning "
                         "above)")
    params = jax.device_get(state_v.params)
    extra_vars = jax.device_get(state_v.extra_vars)
    opt_state = jax.device_get(state_v.opt_state)

    cfg = Config.from_dict(manifest["config"])
    trainer = engine.Trainer(cfg.replace(**blank), manifest["class_names"], device="cpu")
    state = trainer.init_state()
    load_vct_variables(trainer.model, {"params": params, **extra_vars})
    lr = _learning_rate(opt_state, cfg.train.learning_rate)
    count = _load_optimizer(state, trainer._trained, trainer.model, opt_state, params,
                            extra_vars, lr)
    state.step = int(np.asarray(state_v.step))
    state.generator = None  # vct's dropout key has no torch counterpart
    print(f"train state: epoch {epoch}, step {state.step}, {cfg.train.optimizer} over "
          f"{len(trainer._trained)} parameters (count {count}), learning rate {lr:.6g}")
    return lambda dst: save_train_state(dst, state, cfg, manifest["class_names"], epoch, extra)


def convert_caption(src: str) -> Callable[[str], None]:
    """Read a vct caption checkpoint through ``restore_caption_trainer``;
    returns the writer of its vct_torch form."""
    import jax

    from vct.caption.train import restore_caption_trainer
    from vct_torch.bridge import load_vct_variables
    from vct_torch.caption.train import CaptionTrainer
    from vct_torch.caption.vocab import Vocabulary
    from vct_torch.core.config import CaptionConfig

    manifest = _read_json(os.path.join(src, "manifest.json"))
    _, state_v, _ = restore_caption_trainer(os.path.abspath(src))
    params = jax.device_get(state_v.params)
    extra_vars = jax.device_get(state_v.extra_vars)
    opt_state = jax.device_get(state_v.opt_state)

    known = {f.name for f in dataclasses.fields(CaptionConfig)}
    cfg = CaptionConfig(**{k: v for k, v in manifest["config"].items() if k in known})
    trainer = CaptionTrainer(cfg, Vocabulary.from_dict(manifest["vocab"]), device="cpu")
    state = trainer.init_state()
    load_vct_variables(trainer.model, {"params": params, **extra_vars})
    count = _load_optimizer(state, trainer._trained, trainer.model, opt_state, params,
                            extra_vars, cfg.learning_rate)
    # A legacy tree (saved without rng and step) restores the fresh state's
    # step 0; Adam's count is the step there.
    state.step = int(np.asarray(state_v.step)) or count
    state.generator = None  # vct's dropout key has no torch counterpart
    history = {k: v for k, v in manifest.items()
               if k not in ("epoch", "loss", "vocab", "config", "framework")}
    print(f"caption checkpoint: {cfg.model_kind}, epoch {manifest['epoch']}, step "
          f"{state.step}, Adam over {len(trainer._trained)} parameters")
    return lambda dst: trainer.save_checkpoint(dst, state, int(manifest["epoch"]),
                                               manifest["loss"], extra=history)


CONVERTERS = {"model": convert_model, "train_state": convert_train_state,
              "caption": convert_caption}


def convert(src: str, dst: str) -> List[str]:
    """Convert every form SRC holds into DST; returns the forms. Every form
    is read and mapped before anything is written."""
    src, dst = os.path.abspath(src), os.path.abspath(dst)
    if not os.path.isdir(src):
        raise ValueError(f"{src}: not a directory")
    if os.path.realpath(src) == os.path.realpath(dst):
        raise ValueError("DST must be another directory than SRC (the manifests share names)")
    forms = find_forms(src)
    writers: List[Tuple[str, Callable[[str], None]]] = [(f, CONVERTERS[f](src)) for f in forms]
    os.makedirs(dst, exist_ok=True)
    for _, write in writers:
        write(dst)
    return forms


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("src", help="a vct checkpoint directory")
    p.add_argument("dst", help="the vct_torch checkpoint directory to write")
    args = p.parse_args(argv)
    try:
        forms = convert(args.src, args.dst)
    except (ValueError, KeyError) as e:
        print(f"convert_vct_checkpoint: {e}", file=sys.stderr)
        return 1
    print(f"converted {', '.join(forms)} from {args.src} into {args.dst}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
