"""Captioning entry point: ``python -m vct_torch.caption --synthetic
[--device cpu] [...]``, the port of ``vct/caption/__main__.py``.

Build the vocabulary, train teacher-forced with per-epoch checkpoints and
resume, then beam-search the clips with the 'Average BLEU score' print.
``--synthetic`` runs the whole loop on seeded random clips. The modes that
decode video files (``--video_dir/--annotations``, ``--caption_videos``)
are not ported yet (ROADMAP Queue 1 item 3) and exit non-zero.
"""

from __future__ import annotations

import sys

import numpy as np

from vct_torch.caption.data import encode_caption
from vct_torch.caption.train import CaptionTrainer
from vct_torch.caption.vocab import Vocabulary, tokenize_caption
from vct_torch.core.config import CaptionConfig

SENTENCES = ["a man is cooking", "a dog runs fast", "a man runs"]
NOT_PORTED = ("{} decodes video files, which vct_torch does not do yet (ROADMAP Queue 1 "
              "item 3); run python -m vct_torch.caption --synthetic")


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)

    def grab(flag, default=None):
        if flag in argv:
            i = argv.index(flag)
            if i + 1 >= len(argv):
                raise SystemExit(f"{flag} requires an argument")
            val = argv[i + 1]
            del argv[i : i + 2]
            return val
        return default

    def has(flag):
        if flag in argv:
            argv.remove(flag)
            return True
        return False

    for mode in ("--caption_videos", "--video_dir", "--annotations"):
        if mode in argv:
            print(NOT_PORTED.format(mode), file=sys.stderr)
            return 2
    synthetic = has("--synthetic")
    has("--eval")  # accepted: the synthetic run always evaluates, as vct's does
    feature_cache = has("--feature_cache")
    device = grab("--device")  # default: the card
    cfg = CaptionConfig(
        model_kind=grab("--model_kind", "s2vt"),
        cnn_backbone=grab("--backbone", "resnet50"),
        cnn_output_size=int(grab("--cnn_output_size", 512)),
        hidden_size=int(grab("--hidden_size", 512)),
        # 4 = the 1s2vt variant (4-layer encoder/decoder GRUs)
        encoder_layers=int(grab("--encoder_layers", 1)),
        num_frames=int(grab("--num_frames", 30)),
        max_caption_len=int(grab("--max_caption_len", 30)),
        beam_width=int(grab("--beam_width", 3)),
        epochs=int(grab("--epochs", 10)),
        learning_rate=float(grab("--lr", 1e-4)),
        checkpoint_dir=grab("--checkpoint_dir", "/tmp/vct_caption"),
        freq_threshold=int(grab("--freq_threshold", 1)),
        feature_cache=feature_cache,
    )
    batch_size = int(grab("--batch_size", 4))
    if argv:
        print(f"Unknown arguments: {argv}")
        return 2
    if not synthetic:
        print("usage: python -m vct_torch.caption --synthetic [--device cpu] [--epochs N] "
              "[--beam_width K] [--eval] [--model_kind s2vt|transformer|v1_lstm|v1_gru] ...")
        return 2

    vocab = Vocabulary(cfg.freq_threshold)
    vocab.build_vocabulary(SENTENCES)
    rng = np.random.RandomState(0)
    videos = rng.rand(6, cfg.num_frames, 64, 64, 3).astype(np.float32)
    captions = np.stack([encode_caption(SENTENCES[i % 3], vocab, cfg.max_caption_len)
                         for i in range(6)])
    refs = [[tokenize_caption(SENTENCES[i % 3])] for i in range(6)]
    print(f"Vocabulary size: {len(vocab)}; dataset: {videos.shape}")
    trainer = CaptionTrainer(cfg, vocab, device=device)
    state = trainer.init_state()
    state, losses = trainer.fit(state, videos, captions, batch_size=batch_size,
                                checkpoint_dir=cfg.checkpoint_dir)
    print(losses)
    trainer.evaluate_bleu(state, videos, refs)
    for words in trainer.caption_videos(state, videos[:2]):
        print("Caption:", " ".join(words))
    return 0


if __name__ == "__main__":
    sys.exit(main())
