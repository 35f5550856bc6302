"""Caption training and evaluation: the port of ``vct/caption/train.py``.

Teacher-forced cross-entropy ignoring <pad>, global-norm clipping then Adam
over everything but the frozen backbone (``optax.set_to_zero`` there in
``vct``: no update, no Adam state, outside the clip's norm), per-epoch
checkpoints with resume (``s2vt/beam_search.py:207-226,441-480``;
``main_configurable.py:337-457``), greedy and beam-search evaluation with the
'Average BLEU score' print.

A checkpoint directory holds

    <dir>/caption_state.pt   the train state: the model's and Adam's
                             state_dicts, the step, the dropout generator
    <dir>/manifest.json      framework, epoch, loss, vocab, config and the
                             epoch history

each written to a temporary name and swapped in (the manifest last), as
``vct_torch.train.checkpoint`` writes; a resumed run reproduces the
uninterrupted one bit for bit. ``vct``'s Orbax caption checkpoints are
refused; ``python convert_vct_checkpoint.py SRC DST``, run where ``vct``
runs, converts one into this layout.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from vct_torch.caption.beam import beam_search, decode_tokens, greedy_decode
from vct_torch.caption.bleu import corpus_average_bleu
from vct_torch.caption.data import as_caption_loader
from vct_torch.caption.models import S2VTModel
from vct_torch.caption.vocab import Vocabulary
from vct_torch.core.config import CaptionConfig
from vct_torch.data.preprocess import preprocess_clips
from vct_torch.device import resolve_device
from vct_torch.models import init_weights
from vct_torch.models.layers import Dropout
from vct_torch.train.checkpoint import (
    FRAMEWORK,
    _atomic_json,
    _atomic_save,
    _read_manifest,
    restore_train_state,
    train_state_payload,
)
from vct_torch.train.engine import TrainState, clip_by_global_norm
from vct_torch.utils.profiling import StepTimer, write_history

__all__ = ["CaptionTrainer", "build_captioner", "restore_caption_trainer"]

PAD_ID = 0
BACKBONE = "cnn.cnn."  # the frozen backbone's parameter names start so
_STATE = "caption_state.pt"
_MANIFEST = "manifest.json"


def _make_captioner(cfg: CaptionConfig, vocab_size: int):
    if cfg.model_kind == "transformer":
        from vct_torch.caption.transformer import TransformerCaptioner

        return TransformerCaptioner(
            vocab_size=vocab_size, cnn_backbone=cfg.cnn_backbone,
            cnn_output_size=cfg.cnn_output_size, hidden_size=cfg.hidden_size,
            max_len=cfg.max_caption_len, dropout=cfg.dropout)
    if cfg.model_kind in ("v1_lstm", "v1_gru"):
        from vct_torch.caption.v1_rnn import V1RNNCaptioner

        return V1RNNCaptioner(
            vocab_size=vocab_size, cnn_backbone=cfg.cnn_backbone,
            embed_size=cfg.cnn_output_size, hidden_size=cfg.hidden_size,
            rnn_type=cfg.model_kind.split("_")[1], max_len=cfg.max_caption_len)
    if cfg.model_kind != "s2vt":
        raise KeyError(f"Unknown caption.model_kind {cfg.model_kind!r}; "
                       "available: s2vt, transformer, v1_lstm, v1_gru")
    return S2VTModel(
        vocab_size=vocab_size, cnn_backbone=cfg.cnn_backbone,
        cnn_output_size=cfg.cnn_output_size, hidden_size=cfg.hidden_size,
        max_len=cfg.max_caption_len, dropout=cfg.dropout, rnn_layers=cfg.encoder_layers)


def build_captioner(cfg: CaptionConfig, vocab_size: int, device=None, seed: int = 0):
    """The captioner family ``cfg.model_kind`` names (s2vt, transformer,
    v1_lstm, v1_gru) on ``device`` (default: the card), weights from
    ``seed`` (``vct_torch.models.init_weights``), in eval mode. Load trained
    weights with ``vct_torch.bridge.load_vct_variables`` or a checkpoint."""
    dev = resolve_device(device)
    with torch.device("meta"):
        model = _make_captioner(cfg, vocab_size)
    model.to_empty(device=dev)
    init_weights(model, seed)
    return model.to(memory_format=torch.channels_last).eval()


class CaptionTrainer:
    def __init__(self, cfg: CaptionConfig, vocab: Vocabulary, device=None, seed: int = 0):
        self.cfg = cfg
        self.vocab = vocab
        self.seed = seed
        self.device = resolve_device(device)
        self.model = build_captioner(cfg, len(vocab), self.device, seed)
        # Frozen CNN backbone; its projection fc trains (beam_search.py:
        # 290-291 wraps only the feature extractor in no_grad).
        self._trained = []
        for name, p in self.model.named_parameters():
            p.requires_grad_(not name.startswith(BACKBONE))
            if p.requires_grad:
                self._trained.append(p)
        # The steps consume cached backbone features (set in fit).
        self._feature_mode = False

    # ------------------------------------------------------------------
    def init_state(self) -> TrainState:
        """Adam over the trained parameters and a dropout generator on the
        device seeded from ``seed``, wired into every Dropout of the model."""
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        for mod in self.model.modules():
            if isinstance(mod, Dropout):
                mod.generator = gen
        opt = torch.optim.Adam(self._trained, lr=self.cfg.learning_rate, betas=(0.9, 0.999),
                               eps=1e-8)
        return TrainState(model=self.model, optimizer=opt, generator=gen)

    @staticmethod
    def _token_nll(logp, captions, row_mask):
        """(mean CE over non-pad tokens of valid rows, token count).

        CE(ignore_index=<pad>) over (B, L, V) against targets (B, L): logit i
        against ``captions[:, i]``; ``row_mask`` zeroes the loader's padding
        rows."""
        tgt = captions.long()
        nll = -torch.gather(logp, -1, tgt[..., None])[..., 0]
        tok = (tgt != PAD_ID).to(torch.float32) * row_mask[:, None]
        count = torch.sum(tok)
        return torch.sum(nll * tok) / torch.clamp_min(count, 1.0), count

    def _forward(self, video, captions):
        if self._feature_mode:
            return self.model(video, captions, from_features=True)
        return self.model(video, captions)

    def _train_step(self, state: TrainState, video, captions, mask):
        """One step: forward in train mode, loss, backward, clip, Adam.
        Returns the device scalars (loss, token count)."""
        state.model.train()
        loss, tokens = self._token_nll(self._forward(video, captions), captions, mask)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        if self.cfg.grad_clip:
            clip_by_global_norm(self._trained, self.cfg.grad_clip)
        state.optimizer.step()
        state.step += 1
        return loss.detach(), tokens

    def _put_batch(self, xb, yb, mask):
        """One batch on the device; uint8 clips are normalized there."""
        return (self._prep_videos(xb), torch.from_numpy(np.asarray(yb, np.int64)).to(self.device),
                torch.from_numpy(np.asarray(mask, np.float32)).to(self.device))

    def _prep_videos(self, videos):
        videos = np.asarray(videos)
        if videos.dtype == np.uint8:
            return preprocess_clips(torch.from_numpy(videos).to(self.device))
        return torch.from_numpy(np.ascontiguousarray(videos, np.float32)).to(self.device)

    # ------------------------------------------------------------------
    def fit(self, state: TrainState, videos, captions: Optional[np.ndarray] = None,
            batch_size: int = 4, checkpoint_dir: Optional[str] = None, log: bool = True,
            val=None) -> Tuple[TrainState, List[float]]:
        """The teacher-forced epoch loop with the classifier engine's
        discipline. ``videos`` is an in-memory clip array (with
        ``captions``) or a caption batch loader. Per-step scalars stay on the
        device for the whole epoch (one fetch an epoch; ``log_every`` adds a
        synced step line); a resumed run fast-forwards the shuffle stream, so
        its epoch k trains on the uninterrupted run's permutation. ``val``:
        an optional (videos, captions) tuple or loader scored each epoch.
        Checkpoints go to ``checkpoint_dir`` or ``cfg.checkpoint_dir`` after
        every epoch, and a run with a checkpoint there resumes from it."""
        cfg = self.cfg
        loader = as_caption_loader(videos, captions, batch_size)
        val_loader = None
        if val is not None:
            val_loader = (as_caption_loader(val[0], val[1], batch_size)
                          if isinstance(val, tuple) else as_caption_loader(val))
        self._feature_mode = bool(cfg.feature_cache
                                  and getattr(self.model, "supports_feature_cache", False))
        ckpt_dir = checkpoint_dir or cfg.checkpoint_dir
        start_epoch = 0
        loss_arr: List[float] = []
        val_arr: List[float] = []
        if ckpt_dir and os.path.exists(os.path.join(ckpt_dir, _MANIFEST)):
            state, start_epoch, manifest = self.load_checkpoint(ckpt_dir, state)
            # The pre-crash history continues.
            loss_arr = list(manifest.get("epoch_losses", []))
            val_arr = list(manifest.get("val_losses", []))
            print(f"Checkpoint loaded. Resuming from epoch {start_epoch}")
        if self._feature_mode and start_epoch < cfg.epochs:
            # After the restore: a resumed run's features come from the
            # checkpoint's backbone, not the fresh init's.
            t0 = time.time()
            fx, fy = self._extract_features(state, loader)
            loader = as_caption_loader(fx, fy, batch_size)
            if val_loader is not None:
                vx, vy = self._extract_features(state, val_loader)
                val_loader = as_caption_loader(vx, vy, batch_size)
            if log:
                print(f"feature_cache: extracted {fx.shape} backbone features "
                      f"in {time.time() - t0:.1f}s")
        rng = np.random.RandomState(0)
        # Every loader consumes exactly one permutation an epoch.
        for _ in range(start_epoch):
            rng.permutation(loader.num_examples)
        timer = StepTimer()
        start = time.time()
        for epoch in range(start_epoch, cfg.epochs):
            step_stats = []  # (loss, token count) device scalars
            for step_i, (xb, yb, mask) in enumerate(loader.epoch(rng)):
                timer.start()
                loss, tokens = self._train_step(state, *self._put_batch(xb, yb, mask))
                timer.step()
                if cfg.log_every and (step_i + 1) % cfg.log_every == 0:
                    loss_f = loss.item()  # the sync that closes the timer's span
                    timer.sync()
                    print(f"step {state.step}: loss {loss_f:.4f} ({timer.last_ms:.1f} ms/step)")
                step_stats.append(torch.stack([loss, tokens]))
            # One fetch an epoch; the epoch loss is the token-weighted mean.
            if step_stats:
                losses, toks = torch.stack(step_stats).cpu().numpy().T
                timer.sync()
                epoch_loss = float(np.dot(losses, toks)) / max(float(toks.sum()), 1.0)
            else:
                epoch_loss = 0.0
            loss_arr.append(epoch_loss)
            if log:
                print(f"Epoch [{epoch + 1}/{cfg.epochs}], Loss: {epoch_loss}")
            if val_loader is not None:
                val_loss = self._val_loss(state, val_loader)
                val_arr.append(val_loss)
                if log:
                    print(f"Validation Loss: {val_loss:.4f}")
            if ckpt_dir:
                self.save_checkpoint(ckpt_dir, state, epoch + 1, epoch_loss,
                                     extra={"epoch_losses": loss_arr, "val_losses": val_arr})
        if cfg.history_path:
            write_history(cfg.history_path, {
                "train_loss": loss_arr,
                "val_loss": val_arr,
                "training_duration": time.time() - start,
                "step_times": timer.summary(),
            })
        return state, loss_arr

    @torch.no_grad()
    def _extract_features(self, state: TrainState, loader):
        """One pass over the loader: frozen-backbone features (N, T, F) and
        captions, in loader order, on the host."""
        state.model.eval()
        chunks, caps = [], []
        for xb, yb, mask in loader.epoch():
            n = int(np.sum(mask))
            if n == 0:
                continue
            chunks.append(state.model.extract_features(self._prep_videos(xb))[:n])
            caps.append(np.asarray(yb)[:n])
        if not chunks:
            raise ValueError("feature_cache: loader yielded no examples")
        return torch.cat(chunks).cpu().numpy(), np.concatenate(caps, axis=0)

    @torch.no_grad()
    def _val_loss(self, state: TrainState, val_loader) -> float:
        """Token-weighted mean CE over the val set in eval mode; one fetch."""
        state.model.eval()
        stats = []
        for xb, yb, mask in val_loader.epoch():
            xd, yd, md = self._put_batch(xb, yb, mask)
            stats.append(torch.stack(self._token_nll(self._forward(xd, yd), yd, md)))
        if not stats:
            return 0.0
        losses, toks = torch.stack(stats).cpu().numpy().T
        return float(np.dot(losses, toks)) / max(float(toks.sum()), 1.0)

    # ------------------------------------------------------------------
    def save_checkpoint(self, path: str, state: TrainState, epoch: int, loss: float,
                        extra: Optional[dict] = None) -> None:
        path = os.path.abspath(path)
        os.makedirs(path, exist_ok=True)
        _atomic_save(train_state_payload(state), os.path.join(path, _STATE))
        # The config and vocab make the checkpoint self-describing.
        _atomic_json({"framework": FRAMEWORK, "epoch": epoch, "loss": loss,
                      "vocab": self.vocab.to_dict(), "config": dataclasses.asdict(self.cfg),
                      **(extra or {})}, os.path.join(path, _MANIFEST))
        print(f"Checkpoint saved at epoch {epoch}")

    def load_checkpoint(self, path: str, state: TrainState) -> Tuple[TrainState, int, dict]:
        """Restore ``state`` in place from ``path``; returns (state,
        completed epochs, manifest). The vocab comes from the manifest: the
        weights mean something only against the ids they were trained with."""
        manifest = _read_manifest(path, _MANIFEST)
        self.vocab = Vocabulary.from_dict(manifest["vocab"])
        saved = torch.load(os.path.join(os.path.abspath(path), _STATE), map_location="cpu",
                           weights_only=True)
        restore_train_state(saved, state)
        return state, int(manifest["epoch"]), manifest

    # ------------------------------------------------------------------
    def _decode_batch(self, model, videos, beam_width: int) -> List[List[str]]:
        video = self._prep_videos(videos)
        if beam_width <= 1:
            tokens = greedy_decode(model, video, max_len=self.cfg.max_caption_len)
        else:
            tokens, _ = beam_search(model, video, beam_width=beam_width,
                                    max_len=self.cfg.max_caption_len)
        return [decode_tokens(row, self.vocab) for row in tokens.cpu().numpy()]

    def caption_videos(self, state: TrainState, videos,
                       beam_width: Optional[int] = None) -> List[List[str]]:
        """Decode captions for an array of clips or a caption loader (each
        fixed-shape batch decoded on the device, padded rows dropped on the
        host, as the reference's beam eval decodes per DataLoader batch,
        ``s2vt/beam_search.py:488-491``)."""
        beam_width = beam_width if beam_width is not None else self.cfg.beam_width
        if not hasattr(videos, "epoch"):
            return self._decode_batch(state.model, videos, beam_width)
        hyps: List[List[str]] = []
        for xb, _, mask in videos.epoch():
            rows = self._decode_batch(state.model, xb, beam_width)
            hyps.extend(r for r, m in zip(rows, mask) if m > 0)
        return hyps

    def evaluate_bleu(self, state: TrainState, videos,
                      references: Optional[List[List[List[str]]]] = None,
                      beam_width: Optional[int] = None, log: bool = True) -> float:
        if references is None and not hasattr(videos, "references"):
            raise TypeError("references required unless the loader carries them")
        start = time.time()
        hyps = self.caption_videos(state, videos, beam_width)
        if references is None:
            references = videos.references
        avg = corpus_average_bleu(list(zip(references, hyps)))
        if log:
            print(f"Average BLEU score: {avg:.4f}")
            print(f"inference_duration: {time.time() - start:.4f}")
        return avg


def restore_caption_trainer(ckpt_dir: str, device=None
                            ) -> Tuple[CaptionTrainer, TrainState, CaptionConfig]:
    """(trainer, restored state, config) from a self-describing vct_torch
    caption checkpoint directory: the manifest records config and vocab, so
    no training flags are replayed. The port needs no frame geometry to
    build the model, unlike ``vct``'s (``height``/``width`` there)."""
    manifest = _read_manifest(ckpt_dir, _MANIFEST)
    known = {f.name for f in dataclasses.fields(CaptionConfig)}
    cfg = CaptionConfig(**{k: v for k, v in manifest["config"].items() if k in known})
    trainer = CaptionTrainer(cfg, Vocabulary.from_dict(manifest["vocab"]), device=device)
    state = trainer.init_state()
    state, _, _ = trainer.load_checkpoint(ckpt_dir, state)
    return trainer, state, cfg
