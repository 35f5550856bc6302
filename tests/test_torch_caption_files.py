"""vct_torch's caption data from video files against vct's, on the CPU.

The same mp4v files, written with this host's cv2 as
tests/test_caption_stream.py writes them, go through both packages:
frame extraction (interval, raw with and without ``target_frames``, over
capacity) and ``load_caption_dataset`` bit-equal; ``LazyCaptionLoader``'s
batches, masks, references, missing and corrupt files and ``peek`` equal,
epoch by epoch, with one permutation a shuffled epoch. Then a lazy ``fit``
(uint8 clips divided on the device) crashed after epoch 1 and resumed is
bit-equal to the in-memory ``fit`` on ``load_caption_dataset``'s clips
(divided on the host), with and without the feature cache, and within rtol
1e-5 of vct's lazy ``fit`` from the same weights (vct's XLA turns the
division into a multiplication by 1/255, ROADMAP Known differences).
"""

import dataclasses

import numpy as np
import pytest
import torch

import torch_caption_common as common
from vct.caption import data as vct_data
from vct.caption import train as vct_train
from vct_torch.bridge import load_vct_variables
from vct_torch.caption import data
from vct_torch.caption.train import CaptionTrainer
from vct_torch.caption.vocab import Vocabulary

SIZE = 32
# Frames a video: short ones padded with their last frame, a long one whose
# interval is above 1 at every target.
FRAMES = [4, 5, 6, 13, 4]


@pytest.fixture(scope="module")
def videos(tmp_path_factory):
    """A directory of len(FRAMES) seeded mp4v videos, a corrupt file, and two
    annotation files: ``clean.txt`` (the readable videos) and ``ann.txt``
    (also a missing file and the corrupt one)."""
    pytest.importorskip("cv2")
    root = tmp_path_factory.mktemp("capfiles")
    rng = np.random.RandomState(0)
    lines = []
    for i, n in enumerate(FRAMES):
        common.write_video(root / f"vid{i}.mp4", n, rng, SIZE)
        lines.append(f"vid{i} {common.SENTENCES[i % len(common.SENTENCES)]}")
    (root / "bad.mp4").write_bytes(b"not a video at all")
    (root / "clean.txt").write_text("\n".join(lines) + "\n")
    (root / "ann.txt").write_text("\n".join(lines[:1] + ["bad a dog runs", "ghost a man runs"]
                                            + lines[1:]) + "\n")
    return root


def _paths(root):
    return [str(root / f"vid{i}.mp4") for i in range(len(FRAMES))]


def _vocabs():
    port = Vocabulary(freq_threshold=1)
    port.build_vocabulary(common.SENTENCES)
    return common.vocab(), port


@pytest.mark.parametrize("as_uint8", [False, True], ids=["f32", "uint8"])
@pytest.mark.parametrize("target", [2, 3, 8])
def test_extract_frames_interval_is_vcts(videos, target, as_uint8):
    for path in _paths(videos):
        want = vct_data.extract_frames_interval(path, target, SIZE, as_uint8=as_uint8)
        got = data.extract_frames_interval(path, target, SIZE, as_uint8=as_uint8)
        assert got.dtype == want.dtype and got.shape == (target, SIZE, SIZE, 3)
        assert np.array_equal(got, want), path
    for fn in (vct_data.extract_frames_interval, data.extract_frames_interval):
        with pytest.raises(IOError, match="Could not open"):
            fn(str(videos / "bad.mp4"), target, SIZE)


@pytest.mark.parametrize("max_frames,target", [(20, None), (5, None), (20, 3), (5, 3)],
                         ids=["within", "over_capacity_cut", "within_target",
                              "over_capacity_interval"])
def test_extract_frames_raw_is_vcts(videos, capsys, max_frames, target):
    printed = ""
    for path in _paths(videos):
        want = vct_data.extract_frames_raw(path, max_frames, SIZE, target_frames=target)
        want_out = capsys.readouterr().out
        got = data.extract_frames_raw(path, max_frames, SIZE, target_frames=target)
        assert capsys.readouterr().out == want_out
        assert got.dtype == np.uint8 and np.array_equal(got, want), path
        printed += want_out
    # The 13-frame video is over a capacity of 5: cut with a warning, or
    # interval-extracted to the target.
    assert ("exceeds the raw capacity" in printed) == (max_frames == 5 and target is None)


def test_load_caption_dataset_is_vcts(videos, capsys):
    vocab_v, vocab_t = _vocabs()
    want = vct_data.load_caption_dataset(str(videos), str(videos / "ann.txt"), vocab_v,
                                         num_frames=3, max_caption_len=6, size=SIZE,
                                         video_ext=".mp4")
    want_out = capsys.readouterr().out
    got = data.load_caption_dataset(str(videos), str(videos / "ann.txt"), vocab_t, num_frames=3,
                                    max_caption_len=6, size=SIZE, video_ext=".mp4")
    assert capsys.readouterr().out == want_out
    assert "Error processing bad" in want_out and "Error processing ghost" in want_out
    assert got[0].dtype == np.float32 and np.array_equal(got[0], want[0])
    assert np.array_equal(got[1], want[1]) and got[2] == want[2]
    assert len(got[2]) == len(FRAMES)
    limited = data.load_caption_dataset(str(videos), str(videos / "clean.txt"), vocab_t,
                                        num_frames=3, max_caption_len=6, size=SIZE,
                                        video_ext=".mp4", limit=2)
    assert limited[0].shape == (2, 3, SIZE, SIZE, 3)


def _loaders(videos, ann="ann.txt", ext=".mp4", batch_size=2):
    vocab_v, vocab_t = _vocabs()
    kw = dict(batch_size=batch_size, num_frames=3, max_caption_len=6, size=SIZE,
              video_ext=ext)
    return (vct_data.LazyCaptionLoader(str(videos), str(videos / ann), vocab_v, **kw),
            data.LazyCaptionLoader(str(videos), str(videos / ann), vocab_t, **kw))


def test_lazy_loader_batches_masks_and_references_are_vcts(videos, capsys):
    """Epoch by epoch (in order, then two shuffled): the missing file skipped
    at construction, the corrupt one masked mid-epoch and dropped at the next
    epoch, the references aligned, one permutation an epoch."""
    want_l, got_l = _loaders(videos)  # each prints its skip of the missing file
    assert capsys.readouterr().out == "Error processing ghost: file not found\n" * 2
    assert got_l.num_examples == want_l.num_examples == len(FRAMES) + 1
    rng_v, rng_t = np.random.RandomState(7), np.random.RandomState(7)
    for rngs in ((None, None), (rng_v, rng_t), (rng_v, rng_t)):
        want = list(want_l.epoch(rngs[0]))
        want_out = capsys.readouterr().out
        got = list(got_l.epoch(rngs[1]))
        assert capsys.readouterr().out == want_out
        assert len(got) == len(want)
        for (xg, yg, mg), (xw, yw, mw) in zip(got, want):
            assert xg.dtype == np.uint8 and np.array_equal(xg, xw)
            assert np.array_equal(yg, yw) and np.array_equal(mg, mw)
        assert got_l.references == want_l.references
        assert got_l.num_examples == want_l.num_examples
    assert got_l.num_examples == len(FRAMES)  # the corrupt file dropped after epoch 1
    assert len(got_l.references) == len(FRAMES)
    assert rng_t.randint(1 << 30) == rng_v.randint(1 << 30)
    first = list(want_l.epoch())[0][2]
    np.testing.assert_array_equal(first, [1.0, 1.0])


def test_lazy_loader_masks_the_corrupt_row_and_peek_skips_it(videos, capsys):
    want_l, got_l = _loaders(videos)
    batches = list(got_l.epoch())
    np.testing.assert_array_equal(batches[0][2], [1.0, 0.0])  # vid0, then bad.mp4
    assert "Error processing bad.mp4" in capsys.readouterr().out
    assert len(got_l.references) == len(FRAMES)
    # peek: the first decodable item (bad.mp4 put first in a fresh pair)
    (videos / "peek.txt").write_text("bad a dog runs\nvid3 a man runs\n")
    want_l, got_l = _loaders(videos, ann="peek.txt")
    (xw, yw), (xg, yg) = want_l.peek(), got_l.peek()
    assert xg.shape == (1, 3, SIZE, SIZE, 3) and np.array_equal(xg, xw)
    assert np.array_equal(yg, yw)
    for loader in _loaders(videos, ext=".avi"):  # no .avi files: nothing decodes
        with pytest.raises(ValueError, match="no decodable clips"):
            loader.peek()


@pytest.mark.parametrize("feature_cache", [False, True])
def test_lazy_fit_resumed_is_the_in_memory_fit(videos, tmp_path, feature_cache):
    """Dropout on: a lazy fit crashed after epoch 1 and resumed to 2 against
    a straight in-memory fit of the same clips: losses, weights, step and
    dropout generator bit-equal."""
    _, cfg = common.configs("s2vt", dropout=0.3, learning_rate=1e-3, epochs=2,
                            feature_cache=feature_cache)
    _, vocab = _vocabs()
    x, y, _ = data.load_caption_dataset(str(videos), str(videos / "clean.txt"), vocab,
                                        num_frames=3, max_caption_len=6, size=SIZE,
                                        video_ext=".mp4")
    straight = CaptionTrainer(cfg, vocab, device="cpu", seed=3)
    s1, want = straight.fit(straight.init_state(), x, y, batch_size=2,
                            checkpoint_dir=str(tmp_path / "a"), log=False)

    def lazy():
        return _loaders(videos, ann="clean.txt")[1]

    first = CaptionTrainer(dataclasses.replace(cfg, epochs=1), vocab, device="cpu", seed=3)
    first.fit(first.init_state(), lazy(), batch_size=2, checkpoint_dir=str(tmp_path / "b"),
              log=False)
    resumed = CaptionTrainer(cfg, vocab, device="cpu", seed=9)
    s2, got = resumed.fit(resumed.init_state(), lazy(), batch_size=2,
                          checkpoint_dir=str(tmp_path / "b"), log=False)
    assert got == want and s2.step == s1.step == 6
    for (n, a), (_, b) in zip(s1.model.state_dict().items(), s2.model.state_dict().items()):
        assert torch.equal(a, b), n
    assert torch.equal(s1.generator.get_state(), s2.generator.get_state())


def test_lazy_fit_matches_vcts_lazy_fit(videos):
    """Two epochs from one seeded variables tree (dropout 0), both lazy."""
    extra = dict(learning_rate=1e-3, epochs=2, checkpoint_dir="")
    _, variables, _, cfg_t = common.pair("s2vt", **extra)
    cfg_v, _ = common.configs("s2vt", **extra)
    want_l, got_l = _loaders(videos, ann="clean.txt")
    trainer_v = vct_train.CaptionTrainer(cfg_v, common.vocab())
    _, want = trainer_v.fit(common.vct_state(trainer_v, variables), want_l, batch_size=2,
                            log=False)
    trainer = CaptionTrainer(cfg_t, _vocabs()[1], device="cpu")
    load_vct_variables(trainer.model, variables)
    state, got = trainer.fit(trainer.init_state(), got_l, batch_size=2, log=False)
    assert len(got) == 2 and state.step == 6
    np.testing.assert_allclose(got, want, rtol=1e-5)
