"""Train / eval engine: the port of ``vct/train/engine.py`` on one card.

The training semantics of ``vct`` (and of the reference,
``medsos_lrcn/src/train_eval.py``):

* multiclass: cross-entropy, optionally class-weighted like torch
  ``CrossEntropyLoss(weight=...)`` (weighted mean over the valid rows);
  multiple_binary: per-class ``BCEWithLogits(pos_weight)``, the mean over
  valid rows summed over classes;
* the frozen backbone: with ``model.finetune`` off no backbone parameter
  requires a gradient (the LRCN then runs it under ``torch.no_grad``) or
  reaches the optimizer; with it on, ``model.freeze_until``'s prefixes stay
  frozen the same way (optax's ``set_to_zero``: no update, no decay);
* adam, adamw (decoupled decay, scaled by the learning rate) and sgd, the
  learning rate in ``param_groups`` (optax's ``inject_hyperparams``) so the
  plateau scheduler lowers it between epochs, and global-norm clipping over
  the trained parameters only (optax's ``clip_by_global_norm``: scaled by
  ``max_norm / norm`` where the norm reaches ``max_norm``);
* the epoch line, both early stops, plateau learning-rate decay on the val
  loss (or the train loss without val data), the feature cache, and the
  metric block of ``vct.core.metrics_contract``.

Per-step scalars stay on the device for a whole epoch; one fetch an epoch
(``train.log_every`` syncs every N steps to print a step line). A backbone's
BatchNorm stays in eval mode under ``train()`` (``backbones.common.Backbone``);
the scratch CNN ``lrcn2``'s trains on batch statistics, as in ``vct``.
Dropout draws its masks from a ``torch.Generator`` on the device seeded from
``train.seed``, part of the train state.

``train.resume`` saves the full train state every epoch under
``train.model_path`` and continues from it (``vct_torch.train.checkpoint``);
``train.init_from`` warm-starts from a checkpoint, ``model.backbone_weights``
loads torchvision backbone weights (``vct_torch.models.backbones.port``);
``train.profile_dir`` traces the first epoch that runs and
``train.history_path`` writes the history JSON (``vct_torch.utils.profiling``).
``fit`` takes in-memory arrays or any loader of ``vct_torch.data.loaders``
(the streamed path, ``vct_torch.train.stream``); ``fit_stream`` is ``vct``'s
alias of it.

Across ranks (``vct_torch.parallel``): under a process group the trainer
spans a (data, model) mesh of the world's ranks (``mesh.data_axis`` /
``mesh.model_axis``), one process a rank, with ``vct``'s semantics. Every
rank reads the same global batch, padded with mask-0 rows to a multiple of
the data axis, and computes on its data row's slice; the loss divides by
the denominators summed over the data axis (``sum(w)``, ``sum(mask)``), so
it is the one-process loss and not a mean of the ranks' means, and the
gradients, ``correct`` and ``total`` are summed over it. Parameters that
``vct``'s rule column-shards (``vct_torch.parallel.shard``) keep one block
a rank of the model axis, as do their Adam moments; each forward joins the
blocks (gradients flow back to each rank's block) and the global norm of
the clip sums the blocks' squares over the model axis. Dropout draws the
global batch's masks and keeps a rank's rows. Validation, evaluation and
feature extraction shard the same way, and every decision reads global
values, so every rank takes the same branch. Without a process group the
trainer runs on one device: training across devices runs one process a
rank (``torchrun``), not one program over several devices.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from vct_torch.core.config import Config
from vct_torch.core.metrics_contract import (
    RunMetrics,
    print_epoch_line,
    print_metric_block,
    print_param_counts,
    print_training_duration,
)
from vct_torch.data.loaders import as_loader
from vct_torch.data.preprocess import preprocess_clips
from vct_torch.device import resolve_device
from vct_torch.models import build_model
from vct_torch.models.backbones.port import load_state_dict_file, port_backbone_into_model
from vct_torch.models.layers import Dropout
from vct_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, activate_mesh, make_mesh
from vct_torch.parallel.multihost import is_primary
from vct_torch.parallel.shard import gather_params, shard_params
from vct_torch.train.checkpoint import (
    load_checkpoint,
    load_train_state,
    load_weights,
    save_train_state,
)
from vct_torch.train.metrics import (
    macro_auc,
    multiclass_confusion,
    multiclass_metrics,
    multilabel_counts,
    multilabel_metrics,
)
from vct_torch.utils.profiling import StepTimer, device_trace, write_history

__all__ = ["TrainState", "Trainer", "clip_by_global_norm", "compute_class_weights",
           "count_parameters"]

FROZEN_KEY = "cnn_backbone"
# Parameters the model declares and never reads (the Mamba mixer's D, kept
# for parameter parity): vct's gradient of them is zero, torch's None.
_UNUSED_SUFFIXES = (".mixer.D",)


def compute_class_weights(y: np.ndarray, num_classes: int, classif_mode: str):
    """Balanced class weights (sklearn's compute_class_weight 'balanced' for
    CE; pos_weight = neg/pos for the per-class BCE losses)."""
    if classif_mode == "multiclass":
        counts = np.bincount(y.astype(np.int64), minlength=num_classes).astype(np.float64)
        weights = len(y) / np.maximum(num_classes * counts, 1.0)
        return weights.astype(np.float32)
    pos = y.sum(axis=0).astype(np.float64)
    neg = len(y) - pos
    return (neg / np.maximum(pos, 1.0)).astype(np.float32)


def clip_by_global_norm(params, max_norm: float, sharded=(), mesh=None) -> None:
    """optax.clip_by_global_norm over the gradients of ``params`` (the
    trained ones), in place: scaled by ``max_norm / norm`` where the global
    norm reaches ``max_norm``. The gradients of the ``sharded`` parameters
    (those of ``params`` that hold a block a rank of ``mesh``'s model axis)
    add their squares over the model axis, so the norm is the whole
    parameters'."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    blocks = {id(p) for p in sharded}
    whole = [p.grad for p in params if p.grad is not None and id(p) not in blocks]
    parts = [p.grad for p in params if p.grad is not None and id(p) in blocks]
    sq = sum(torch.sum(g * g) for g in whole) if whole else grads[0].new_zeros(())
    if parts:
        sq = sq + mesh.all_reduce(sum(torch.sum(g * g) for g in parts), MODEL_AXIS)
    norm = torch.sqrt(sq)
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    for g in grads:
        g.mul_(scale)


def _prefixes(freeze_until: str) -> List[str]:
    return [p.strip() for p in freeze_until.split(",") if p.strip()]


def _is_frozen(name: str, finetune: bool, freeze_until: str = "") -> bool:
    """Whether the parameter ``name`` (a ``named_parameters`` key) stays
    frozen: the whole backbone without finetune, else the backbone
    submodules named by (or starting with) a ``freeze_until`` prefix."""
    top, _, rest = name.partition(".")
    if top != FROZEN_KEY:
        return False
    if not finetune:
        return True
    sub = rest.split(".", 1)[0]
    return any(sub == p or sub.startswith(p) for p in _prefixes(freeze_until))


def count_parameters(model: nn.Module, finetune: bool = False,
                     freeze_until: str = "") -> Dict[str, int]:
    """Trainable / non-trainable / total parameters (``train_eval.py:121-129``);
    BatchNorm's running statistics are buffers and not counted."""
    total = frozen = 0
    for name, p in model.named_parameters():
        total += p.numel()
        if _is_frozen(name, finetune, freeze_until):
            frozen += p.numel()
    return {
        "Trainable parameters": total - frozen,
        "Non-trainable parameters": frozen,
        "Total parameters": total,
    }


@dataclass
class TrainState:
    """The model, its optimizer, the step count and the dropout generator
    (``vct``'s state carries ``rng``). On a mesh whose model axis shards
    parameters, ``mesh``, ``specs`` ({name: sharded dim}) and
    ``param_names`` (the optimizer's parameters, in order) say how the
    blocks join into whole tensors (``checkpoint.gather_state_dict``)."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0
    generator: Optional[torch.Generator] = None
    mesh: object = None
    specs: Optional[Dict[str, int]] = None
    param_names: Optional[List[str]] = None


class Trainer:
    mesh = None  # set in __init__ (a one-device mesh without a process group)

    def __init__(self, cfg: Config, class_names: List[str], mesh=None,
                 class_weights: Optional[np.ndarray] = None, device=None):
        t, m = cfg.train, cfg.model
        if mesh is None:
            # vct's make_mesh() over every device: here the world's ranks
            # under a process group, else this process's one device.
            devices = None if torch.distributed.is_initialized() else [resolve_device(device)]
            mesh = make_mesh(devices, data=cfg.mesh.data_axis, model=cfg.mesh.model_axis)
        elif not mesh.distributed and mesh.size > 1:
            raise ValueError(
                f"{mesh}: training across devices runs one process a rank; start the "
                "ranks with torchrun (python -m vct_torch.train) or vct_torch.tools.dryrun "
                "and build the mesh under their process group")
        self.mesh = mesh
        self.cfg = cfg
        self.class_names = class_names
        self.num_classes = m.num_classes
        self.classif_mode = m.classif_mode
        self.device = mesh.device
        data_size = mesh.shape[DATA_AXIS]
        self._padded_bs = -(-t.batch_size // data_size) * data_size
        self._specs: Optional[Dict[str, int]] = None  # set by init_state
        self._primary = is_primary() if mesh.distributed else True
        self.model = build_model(m, cfg.data.sequence_length, device=self.device, seed=t.seed,
                                 frame_size=(cfg.data.img_height, cfg.data.img_width))
        self.class_weights = (
            torch.as_tensor(class_weights, dtype=torch.float32, device=self.device)
            if class_weights is not None else None
        )
        self._trained = []
        self._trained_names = []
        self._unused = []
        for name, p in self.model.named_parameters():
            frozen = _is_frozen(name, m.finetune, m.freeze_until)
            p.requires_grad_(not frozen)
            if not frozen:
                self._trained.append(p)
                self._trained_names.append(name)
                if name.endswith(_UNUSED_SUFFIXES):
                    self._unused.append(p)
        # Counted whole, before init_state shards anything.
        self._counts = count_parameters(self.model, m.finetune, m.freeze_until)
        # train.feature_cache: the steps consume cached backbone features (set in fit).
        self._feature_mode = False

    # ------------------------------------------------------------------
    def _make_optimizer(self) -> torch.optim.Optimizer:
        t = self.cfg.train
        if t.optimizer == "adam":
            return torch.optim.Adam(self._trained, lr=t.learning_rate, betas=(0.9, 0.999),
                                    eps=1e-8)
        if t.optimizer == "adamw":
            return torch.optim.AdamW(self._trained, lr=t.learning_rate, betas=(0.9, 0.999),
                                     eps=1e-8, weight_decay=t.weight_decay)
        if t.optimizer == "sgd":
            return torch.optim.SGD(self._trained, lr=t.learning_rate)
        raise KeyError(f"Unknown optimizer: {t.optimizer}")

    def init_state(self) -> TrainState:
        """A fresh optimizer over the trained parameters and a dropout
        generator on the device seeded from ``train.seed``, wired into every
        Dropout of the model. The weights are the model's, from
        ``train.seed``, then ``model.backbone_weights`` (a torchvision
        state_dict ported into the backbone), then ``train.init_from`` (a
        vct_torch checkpoint whose every tensor must match the model's
        shape, else ``ValueError``); every rank loads the same. Then each
        rank of a model axis keeps its blocks of the parameters ``vct``'s
        rule shards (``vct_torch.parallel.shard``)."""
        m, t = self.cfg.model, self.cfg.train
        if self._specs is None:
            if m.backbone_weights:
                # The reference's pretrained=True (models.py:133) from a user's file.
                port_backbone_into_model(self.model, m.cnn_backbone,
                                         load_state_dict_file(m.backbone_weights))
            if t.init_from:
                state_dict, _, _, _ = load_checkpoint(t.init_from)
                load_weights(self.model, state_dict, "init_from")
            self._specs = shard_params(self.model, self.mesh)
        gen = torch.Generator(device=self.device).manual_seed(t.seed)
        for mod in self.model.modules():
            if isinstance(mod, Dropout):
                mod.generator = gen
        return TrainState(model=self.model, optimizer=self._make_optimizer(), generator=gen,
                          mesh=self.mesh, specs=self._specs or None,
                          param_names=list(self._trained_names))

    # ------------------------------------------------------------------
    def _global(self, value):
        """``value`` summed over the data axis (a copy; the value itself
        without a data axis)."""
        mesh = self.mesh
        if mesh is None or not mesh.distributed or mesh.shape[DATA_AXIS] == 1:
            return value
        return mesh.all_reduce(value.detach().clone(), DATA_AXIS)

    def _loss_fn(self, logits, labels, mask):
        """(loss, (correct, total)), all device scalars; rows with mask 0
        count for nothing. On a data axis, ``loss`` is this rank's share of
        the global loss (its numerator over the global denominator: the
        shares sum to the loss), and ``correct``/``total`` are this rank's."""
        if self.classif_mode == "multiclass":
            ce = F.cross_entropy(logits, labels, reduction="none")
            w = self.class_weights[labels] * mask if self.class_weights is not None else mask
            loss = torch.sum(ce * w) / torch.clamp_min(self._global(torch.sum(w)), 1e-8)
            preds = torch.argmax(logits, dim=-1)
            correct = torch.sum((preds == labels).to(torch.float32) * mask)
            total = torch.sum(mask)
        else:
            labels_f = labels.to(logits.dtype)
            log_p = F.logsigmoid(logits)
            log_not_p = F.logsigmoid(-logits)
            pw = self.class_weights if self.class_weights is not None else 1.0
            bce = -(pw * labels_f * log_p + (1 - labels_f) * log_not_p)
            per_class_mean = torch.sum(bce * mask[:, None], dim=0) / torch.clamp_min(
                self._global(torch.sum(mask)), 1e-8)
            loss = torch.sum(per_class_mean)
            preds = (torch.sigmoid(logits) > 0.5).to(labels_f.dtype)
            correct = torch.sum((preds == labels_f).to(torch.float32) * mask[:, None])
            total = torch.sum(mask) * self.num_classes
        return loss, (correct, total)

    def _call(self, *args, **kwargs):
        """The model's forward under the mesh, on whole parameters: the
        sharded ones joined from their blocks."""
        with activate_mesh(self.mesh):
            if self._specs:
                return torch.func.functional_call(
                    self.model, gather_params(self.model, self.mesh, self._specs), args, kwargs)
            return self.model(*args, **kwargs)

    def _forward(self, xb):
        return self._call(xb, from_features=True) if self._feature_mode else self._call(xb)

    def _clip_gradients(self) -> None:
        params = dict(self.model.named_parameters())
        sharded = [params[n] for n in (self._specs or {}) if n in params]
        clip_by_global_norm(self._trained, self.cfg.train.grad_clip, sharded, self.mesh)

    def _sync_gradients(self, frames_split: bool) -> None:
        """Sum the gradients over the data axis (one flat buffer); where the
        backbone ran on a 1/model slice of the frames (``seq_shard``), its
        gradients are sums over the model axis too."""
        mesh = self.mesh
        if not mesh.distributed or mesh.size == 1:
            return
        both, data = [], []
        for name, p in zip(self._trained_names, self._trained):
            if p.grad is not None:
                (both if frames_split and name.startswith(FROZEN_KEY + ".") else data).append(p)
        for params, axes in ((data, DATA_AXIS), (both, (DATA_AXIS, MODEL_AXIS))):
            if not params:
                continue
            flat = torch.cat([p.grad.reshape(-1) for p in params])
            mesh.all_reduce(flat, axes)
            offset = 0
            for p in params:
                n = p.grad.numel()
                p.grad.copy_(flat[offset:offset + n].view_as(p.grad))
                offset += n

    def _frames_split(self, xb) -> bool:
        """Whether the backbone runs on a 1/model slice of ``xb``'s frames
        (``vct``'s ``seq_shard`` conditions, on this rank's rows)."""
        model = self.mesh.shape[MODEL_AXIS]
        return (bool(getattr(self.model, "seq_shard", False)) and not self._feature_mode
                and self.mesh.distributed and model > 1 and xb.dim() == 5
                and (xb.shape[0] * xb.shape[1]) % model == 0)

    def _train_step(self, state: TrainState, xb, yb, mask):
        """One step on this rank's rows: forward in train mode, loss,
        backward, the gradients summed over the data axis, clip, update.
        Returns the device scalars (loss, correct, total), global."""
        state.model.train()
        loss, (correct, total) = self._loss_fn(self._forward(xb), yb, mask)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        for p in self._unused:  # optax sees a zero gradient there (adamw decays it)
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        self._sync_gradients(self._frames_split(xb))
        if self.cfg.train.grad_clip and self.cfg.train.grad_clip > 0:
            self._clip_gradients()
        state.optimizer.step()
        state.step += 1
        if self.mesh.distributed and self.mesh.shape[DATA_AXIS] > 1:
            loss, correct, total = self._global(
                torch.stack([loss.detach().to(torch.float32), correct, total]))
            return loss, correct, total
        return loss.detach(), correct, total

    def _pad_batch(self, xb, yb, mask):
        """Pad a global batch with mask-0 rows up to a multiple of the data
        axis: up to the padded ``train.batch_size``, or, for a loader's
        larger batch, to its own next multiple (``vct``'s rule)."""
        data_size = self.mesh.shape[DATA_AXIS]
        target = self._padded_bs
        if xb.shape[0] > target:
            target = -(-xb.shape[0] // data_size) * data_size
        pad = target - xb.shape[0]
        if pad:
            xb = np.concatenate([xb, np.zeros((pad,) + xb.shape[1:], xb.dtype)])
            yb = np.concatenate([yb, np.zeros((pad,) + np.shape(yb)[1:], np.asarray(yb).dtype)])
            mask = np.concatenate([mask, np.zeros(pad, np.float32)])
        return xb, yb, mask

    def _local(self, xb, yb, mask):
        """A padded global batch's rows of this rank's data row."""
        mesh = self.mesh
        if not mesh.distributed or mesh.shape[DATA_AXIS] == 1:
            return xb, yb, mask
        k = xb.shape[0] // mesh.shape[DATA_AXIS]
        rows = slice(mesh.data_index * k, (mesh.data_index + 1) * k)
        return xb[rows], np.asarray(yb)[rows], np.asarray(mask)[rows]

    def _put_global(self, xb, yb, mask):
        """A global batch from a loader, padded, cut to this rank's rows
        and put on the device."""
        return self._put_batch(*self._local(*self._pad_batch(xb, yb, mask)))

    def _gather_rows(self, value):
        """Rows computed on each data row's slice, joined in batch order."""
        if not self.mesh.distributed:
            return value
        return self.mesh.all_gather(value.contiguous(), 0, DATA_AXIS)

    def _put_batch(self, xb, yb, mask):
        """One batch on the device; uint8 clips are normalized there."""
        if xb.dtype == np.uint8:
            xd = preprocess_clips(torch.from_numpy(np.ascontiguousarray(xb)).to(self.device))
        else:
            xd = torch.from_numpy(np.ascontiguousarray(xb, np.float32)).to(self.device)
        if self.classif_mode == "multiclass":
            yd = torch.from_numpy(np.asarray(yb, np.int64)).to(self.device)
        else:
            yd = torch.from_numpy(np.asarray(yb, np.float32)).to(self.device)
        md = torch.from_numpy(np.asarray(mask, np.float32)).to(self.device)
        return xd, yd, md

    @torch.no_grad()
    def _extract_features(self, state: TrainState, loader):
        """One pass over the loader: backbone features (N, T, F) and labels,
        in loader order, on the host."""
        state.model.eval()
        chunks, labels = [], []
        for xb, yb, mask in loader.epoch():
            n = int(np.sum(mask))
            if n == 0:
                continue
            xd, _, _ = self._put_global(xb, yb, mask)
            chunks.append(self._gather_rows(self._call(xd, features_only=True))[:n])
            labels.append(np.asarray(yb)[:n])
        if not chunks:
            raise ValueError("feature_cache: loader yielded no examples")
        return torch.cat(chunks).cpu().numpy(), np.concatenate(labels, axis=0)

    # ------------------------------------------------------------------
    def fit(self, state: TrainState, x, y: Optional[np.ndarray] = None, log: bool = True,
            val=None) -> Tuple[TrainState, RunMetrics]:
        """Epoch loop with the reference's stdout contract. ``x`` is an
        in-memory array (with labels ``y``) or a loader; ``val`` optional
        held-out data, an (x, y) tuple or a loader, whose loss drives the
        patience early stop and the plateau scheduler (else the train loss
        does).

        With ``train.resume`` the train state is saved after every epoch
        under ``train.model_path`` and a run restarts where the saved one
        ended: the shuffle stream, the stop and plateau counters and the
        epoch history continue, so a resumed run equals an uninterrupted
        one; a run that had stopped trains no further."""
        t = self.cfg.train
        log = log and self._primary  # one metric block for a world of ranks
        loader = as_loader(x, y, t.batch_size)
        val_loader = None
        if val is not None:
            val_loader = (as_loader(val[0], val[1], t.batch_size) if isinstance(val, tuple)
                          else as_loader(val, None, t.batch_size))
        self._feature_mode = (t.feature_cache and not self.cfg.model.finetune
                              and getattr(self.model, "supports_feature_cache", False))
        rng = np.random.RandomState(t.seed)
        run = RunMetrics()
        stop = False
        best_loss, bad_epochs = float("inf"), 0
        plateau_best, plateau_bad = float("inf"), 0
        start_epoch = 0
        if t.resume:
            state, start_epoch, saved = load_train_state(t.model_path, state)
            if start_epoch:
                if self._primary:
                    print(f"Resuming training from epoch {start_epoch}")
                # Every loader consumes one permutation an epoch.
                for _ in range(start_epoch):
                    rng.permutation(loader.num_examples)
                best_loss = saved.get("best_loss", best_loss)
                bad_epochs = saved.get("bad_epochs", bad_epochs)
                plateau_best = saved.get("plateau_best", plateau_best)
                plateau_bad = saved.get("plateau_bad", plateau_bad)
                run.epoch_losses = list(saved.get("epoch_losses", []))
                run.epoch_accs = list(saved.get("epoch_accs", []))
                run.val_losses = list(saved.get("val_losses", []))
                if saved.get("stopped"):
                    if self._primary:
                        print("Checkpointed run had early-stopped; not training further.")
                    start_epoch = t.epochs
        if self._feature_mode and start_epoch < t.epochs:
            # After the restore: a resumed run's features come from the
            # checkpoint's backbone, not from the fresh init's.
            t0 = time.time()
            fx, fy = self._extract_features(state, loader)
            loader = as_loader(fx, fy, t.batch_size)
            if val_loader is not None:
                vx, vy = self._extract_features(state, val_loader)
                val_loader = as_loader(vx, vy, t.batch_size)
            if log:
                print(f"feature_cache: extracted {fx.shape} backbone features "
                      f"in {time.time() - t0:.1f}s")
        timer = StepTimer()
        start = time.time()
        for epoch in range(start_epoch, t.epochs):
            step_stats, step_bs = [], []
            # The first epoch this run trains is traced (a resumed run starts past 0).
            with device_trace(t.profile_dir if epoch == start_epoch else None, self.device):
                for step_i, (xb, yb, mask) in enumerate(loader.epoch(rng)):
                    timer.start()
                    loss, c, n = self._train_step(state, *self._put_global(xb, yb, mask))
                    timer.step()
                    step_stats.append(torch.stack([loss.to(torch.float32), c, n]))
                    step_bs.append(float(np.sum(mask)))
                    if t.log_every and (step_i + 1) % t.log_every == 0:
                        loss_f = loss.item()  # the sync that closes the timer's span
                        timer.sync()
                        if self._primary:
                            print(f"step {state.step}: loss {loss_f:.4f} "
                                  f"({timer.last_ms:.1f} ms/step)")
                # One fetch an epoch, inside the trace: it waits for the epoch's work.
                seen = int(sum(step_bs))
                if step_stats:
                    losses, cs, ns = torch.stack(step_stats).cpu().numpy().T
                    timer.sync()
                    epoch_loss = float(np.dot(losses, np.asarray(step_bs))) / max(seen, 1)
                    epoch_acc = float(np.sum(cs)) / max(float(np.sum(ns)), 1.0)
                else:
                    epoch_loss, epoch_acc = 0.0, 0.0
            run.epoch_losses.append(epoch_loss)
            run.epoch_accs.append(epoch_acc)
            if log:
                print_epoch_line(epoch, t.epochs, epoch_loss, epoch_acc)
            monitored = epoch_loss
            if val_loader is not None:
                monitored = self._val_loss(state, val_loader)
                run.val_losses.append(monitored)
                if log:
                    print(f"Validation Loss: {monitored:.4f}")
            if t.early_stop and epoch_loss < t.early_stop:
                stop = True
            if t.early_stop_patience:
                if monitored < best_loss - 1e-6:
                    best_loss, bad_epochs = monitored, 0
                else:
                    bad_epochs += 1
                    if bad_epochs >= t.early_stop_patience:
                        stop = True
            if t.lr_plateau_factor:
                if monitored < plateau_best - 1e-6:
                    plateau_best, plateau_bad = monitored, 0
                else:
                    plateau_bad += 1
                    if plateau_bad >= t.lr_plateau_patience:
                        new_lr = self._scale_learning_rate(state, t.lr_plateau_factor)
                        plateau_bad = 0
                        if log:
                            print(f"Reducing learning rate to {new_lr:.3e}")
            if t.resume:
                save_train_state(t.model_path, state, self.cfg, self.class_names, epoch + 1, extra={
                    "best_loss": best_loss, "bad_epochs": bad_epochs,
                    "plateau_best": plateau_best, "plateau_bad": plateau_bad,
                    "stopped": bool(stop), "epoch_losses": run.epoch_losses,
                    "epoch_accs": run.epoch_accs, "val_losses": run.val_losses,
                })
            if stop:
                break
        run.training_duration = time.time() - start
        counts = self._counts
        run.trainable_params = counts["Trainable parameters"]
        run.non_trainable_params = counts["Non-trainable parameters"]
        run.total_params = counts["Total parameters"]
        if log:
            print_training_duration(run.training_duration)
            print_param_counts(run.trainable_params, run.non_trainable_params)
        if t.history_path and self._primary:
            write_history(t.history_path, {
                "train_loss": run.epoch_losses,
                "train_acc": run.epoch_accs,
                "val_loss": run.val_losses,
                "training_duration": run.training_duration,
                "step_times": timer.summary(),
                "config": self.cfg.to_dict(),
            })
        return state, run

    @staticmethod
    def _scale_learning_rate(state: TrainState, factor: float) -> float:
        """ReduceLROnPlateau's update: every group's learning rate times ``factor``."""
        for group in state.optimizer.param_groups:
            group["lr"] *= factor
        return state.optimizer.param_groups[0]["lr"]

    @torch.no_grad()
    def _val_loss(self, state: TrainState, val_loader) -> float:
        """Mean of the batch losses over the val set, in eval mode."""
        state.model.eval()
        losses = []
        for xb, yb, mask in val_loader.epoch():
            xd, yd, md = self._put_global(xb, yb, mask)
            losses.append(self._global(self._loss_fn(self._forward(xd), yd, md)[0]))
        if not losses:
            return 0.0
        return float(np.mean(torch.stack(losses).cpu().numpy()))

    def fit_stream(self, state: TrainState, loader, log: bool = True):
        """``vct``'s alias: the loader path is ``fit``."""
        return self.fit(state, loader, log=log)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def evaluate(self, state: TrainState, x, y: Optional[np.ndarray] = None, log: bool = True,
                 run: Optional[RunMetrics] = None, compute_auc: bool = False) -> RunMetrics:
        """The metric block over ``x`` (an array with labels ``y``, or a
        loader), in eval mode; counts accumulate on the device, one fetch."""
        state.model.eval()
        log = log and self._primary
        loader = as_loader(x, y, self.cfg.train.batch_size)
        want_auc = compute_auc and self.classif_mode == "multiclass"
        start = time.time()
        n_examples = 0
        if self.classif_mode == "multiclass":
            conf = torch.zeros(self.num_classes, self.num_classes, device=self.device)
            auc_probs, auc_labels = [], []
            for xb, yb, mask in loader.epoch():
                n_valid = int(mask.sum())
                n_examples += n_valid
                xd, yd, md = self._put_global(xb, yb, mask)
                logits = self._call(xd)
                conf += multiclass_confusion(logits, yd, self.num_classes, md)
                if want_auc:
                    probs = self._gather_rows(torch.softmax(logits, dim=-1))
                    auc_probs.append(probs[:n_valid])
                    auc_labels.append(np.asarray(yb)[:n_valid])
            metrics = multiclass_metrics(self._global(conf).cpu().numpy(), self.class_names)
            if auc_probs:
                auc = macro_auc(torch.cat(auc_probs).cpu().numpy(), np.concatenate(auc_labels),
                                self.num_classes)
                metrics.per_class["__auc__"] = {"auc": auc}
                if log:
                    print(f"AUC: {auc:.4f}")
        else:
            counts = torch.zeros(self.num_classes, 4, device=self.device)
            exact = torch.zeros((), device=self.device)
            for xb, yb, mask in loader.epoch():
                n_examples += int(mask.sum())
                xd, yd, md = self._put_global(xb, yb, mask)
                c, e = multilabel_counts(self._call(xd), yd, md)
                counts += c
                exact += e
            counts, exact = self._global(counts), self._global(exact)
            metrics = multilabel_metrics(counts.cpu().numpy(), float(exact.item()),
                                         float(n_examples), self.class_names)
        metrics.inference_duration = time.time() - start
        if run is not None:
            metrics.training_duration = run.training_duration
            metrics.trainable_params = run.trainable_params
            metrics.non_trainable_params = run.non_trainable_params
            metrics.total_params = run.total_params
            metrics.epoch_losses = run.epoch_losses
            metrics.epoch_accs = run.epoch_accs
        if log:
            print_metric_block(metrics, self.class_names, self.classif_mode)
        return metrics
