"""Captioning entry point, the port of ``vct/caption/__main__.py``:

    python -m vct_torch.caption --video_dir DIR --annotations FILE [--eval] [...]
    python -m vct_torch.caption --caption_videos DIR --model CKPT [--beam_width K]
    python -m vct_torch.caption --synthetic [...]

Training builds the vocabulary from the annotation file's captions, trains
teacher-forced with per-epoch checkpoints and resume, the clips decoded a
batch at a time from the video files (``LazyCaptionLoader``), then with
``--eval`` beam-searches them with the 'Average BLEU score' print.
``--caption_videos`` captions a directory of videos from a trained
checkpoint (``vct_torch.caption.infer``). ``--synthetic`` runs the training
loop on seeded random clips. Everything runs on the card unless ``--device
cpu`` is given.
"""

from __future__ import annotations

import sys

import numpy as np

from vct_torch.caption.data import LazyCaptionLoader, encode_caption, preprocess_annotations
from vct_torch.caption.train import CaptionTrainer
from vct_torch.caption.vocab import Vocabulary, tokenize_caption
from vct_torch.core.config import CaptionConfig

SENTENCES = ["a man is cooking", "a dog runs fast", "a man runs"]


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

    # Captioning a directory from a trained checkpoint (beam_search.py:552-570's
    # "Generated Caption:" loop). It branches before any training flag is
    # consumed, so a stray --eval or --video_dir here is an unknown argument.
    caption_videos_dir = grab("--caption_videos")
    if caption_videos_dir is not None:
        model_path = grab("--model")
        beam = grab("--beam_width")
        video_ext = grab("--video_ext")
        height = grab("--height")
        width = grab("--width")
        device = grab("--device")  # default: the card
        if argv:
            print(f"Unknown arguments: {argv}")
            return 2
        if not model_path:
            print("usage: python -m vct_torch.caption --caption_videos DIR --model CKPT "
                  "[--beam_width K] [--video_ext .mp4] [--height 224] [--width 224] "
                  "[--device cpu]")
            return 2
        from vct_torch.caption.infer import caption_directory

        caption_directory(model_path, caption_videos_dir,
                          beam_width=int(beam) if beam else None, video_ext=video_ext,
                          height=int(height) if height else None,
                          width=int(width) if width else None, device=device)
        return 0

    synthetic = has("--synthetic")
    do_eval = has("--eval")
    feature_cache = has("--feature_cache")
    video_dir = grab("--video_dir")
    annotations_path = grab("--annotations")
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
        if not (video_dir and annotations_path):
            print("usage: python -m vct_torch.caption --video_dir DIR --annotations FILE "
                  "[--epochs N] [--beam_width K] [--eval] [--synthetic] [--device cpu] "
                  "[--model_kind s2vt|transformer|v1_lstm|v1_gru] ...")
            return 2
        _, sentences = preprocess_annotations(annotations_path)
        vocab = Vocabulary(cfg.freq_threshold)
        vocab.build_vocabulary(sentences)
        # Out of core: clips decode a batch at a time (uint8, /255 on the device).
        loader = LazyCaptionLoader(video_dir, annotations_path, vocab, batch_size=batch_size,
                                   num_frames=cfg.num_frames,
                                   max_caption_len=cfg.max_caption_len)
        loader.peek()  # raises when no clip decodes
        print(f"Vocabulary size: {len(vocab)}; dataset: {loader.num_examples} clips (lazy)")
        trainer = CaptionTrainer(cfg, vocab, device=device)
        state, losses = trainer.fit(trainer.init_state(), loader, batch_size=batch_size,
                                    checkpoint_dir=cfg.checkpoint_dir)
        print(losses)
        if do_eval:
            trainer.evaluate_bleu(state, loader)
            for words in trainer.caption_videos(state,
                                                loader.peek()[0].astype(np.float32) / 255.0):
                print("Caption:", " ".join(words))
        return 0

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
