"""vct_torch's directory captioning and the caption CLI's file modes against
vct's, on the CPU.

One vct caption checkpoint (the small S2VT of tests/torch_caption_common.py,
seeded weights, saved by vct's trainer) and its conversion by
``convert_vct_checkpoint.py``: the port's ``caption_directory`` and
``python -m vct_torch.caption --caption_videos`` on the converted checkpoint
print the same ``Generated Caption:`` lines as vct's on the original, over
the same cv2-written mp4v files, a corrupt one skipped; the clips go to the
device one chunk at a time. vct's errors are kept (a missing model, no
videos, every file skipped, non-square geometry, systemic decode errors),
and a ``.vctaot`` file is refused naming ROADMAP Queue 1 item 7 (b). Then
``--video_dir/--annotations --eval`` trains from the files and prints vct's
lines.
"""

import json
import os

import numpy as np
import pytest

import convert_vct_checkpoint as convert
import torch_caption_common as common
from vct.caption import __main__ as vct_cli
from vct.caption import infer as vct_infer
from vct.caption import train as vct_train
from vct_torch.caption import __main__ as cli
from vct_torch.caption import infer
from vct_torch.caption.train import CaptionTrainer, restore_caption_trainer

SIZE = common.HW
GEOMETRY = ["--height", str(SIZE), "--width", str(SIZE)]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """(vct checkpoint, its conversion, a directory of 5 mp4 videos and a
    corrupt one, a training directory of the same as .avi files (the
    training CLI reads .avi, as vct's) and its annotation file)."""
    pytest.importorskip("cv2")
    root = tmp_path_factory.mktemp("capinfer")
    _, variables, _, _ = common.pair("s2vt")
    cfg_v, _ = common.configs("s2vt")
    trainer = vct_train.CaptionTrainer(cfg_v, common.vocab())
    state = common.vct_state(trainer, variables)
    src, dst = str(root / "vct_ck"), str(root / "port_ck")
    trainer.save_checkpoint(src, state, epoch=1, loss=1.0)
    assert convert.main([src, dst]) == 0
    vids, train = root / "vids", root / "train"
    vids.mkdir()
    train.mkdir()
    rng = np.random.RandomState(0)
    lines = []
    for i, n in enumerate([4, 6, 5, 9, 4]):
        common.write_video(vids / f"vid{i}.mp4", n, rng, SIZE)
        common.write_video(train / f"vid{i}.avi", n, rng, SIZE, fourcc="MJPG")
        lines.append(f"vid{i} {common.SENTENCES[i % len(common.SENTENCES)]}")
    (vids / "broken.mp4").write_bytes(b"not a video")
    (train / "broken.avi").write_bytes(b"not a video")
    ann = train / "ann.txt"
    ann.write_text("\n".join(lines + ["broken a dog runs"]) + "\n")
    return src, dst, vids, ann


def _generated(text):
    return [line for line in text.splitlines() if "Generated Caption:" in line]


def test_caption_directory_on_a_converted_checkpoint_prints_vcts_captions(setup, capsys):
    src, dst, vids, _ = setup
    want = vct_infer.caption_directory(src, str(vids), height=SIZE, width=SIZE, chunk=2)
    want_out = capsys.readouterr().out
    got = infer.caption_directory(dst, str(vids), height=SIZE, width=SIZE, chunk=2,
                                  device="cpu")
    out = capsys.readouterr().out
    assert got == want and len(got) == 5
    # The converted state carries no dropout generator: restoring it says so.
    warning, *rest = out.splitlines(keepends=True)
    assert warning.startswith("warning: the train state saved no dropout generator")
    assert "".join(rest) == want_out
    assert len(_generated(out)) == 5 and "Error processing broken.mp4" in out


def test_cli_caption_videos_prints_vcts_lines(setup, capsys):
    src, dst, vids, _ = setup
    extra = ["--beam_width", "2", "--video_ext", ".mp4", *GEOMETRY]
    assert vct_cli.main(["--caption_videos", str(vids), "--model", src, *extra]) == 0
    want = _generated(capsys.readouterr().out)
    assert cli.main(["--caption_videos", str(vids), "--model", dst, *extra,
                     "--device", "cpu"]) == 0
    got = _generated(capsys.readouterr().out)
    assert got == want and len(got) == 5


def test_caption_directory_moves_one_chunk_at_a_time(setup, monkeypatch):
    _, dst, vids, _ = setup
    seen = []
    real = CaptionTrainer.caption_videos

    def counted(self, state, videos, beam_width=None):
        seen.append(np.asarray(videos).shape[0])
        return real(self, state, videos, beam_width)

    monkeypatch.setattr(CaptionTrainer, "caption_videos", counted)
    got = infer.caption_directory(dst, str(vids), height=SIZE, width=SIZE, chunk=2,
                                  device="cpu")
    # six files in name order, the corrupt one (first) skipped from its chunk
    assert seen == [1, 2, 2] and len(got) == 5


def _junk_dir(tmp_path):
    d = tmp_path / "junk"
    d.mkdir()
    (d / "x.mp4").write_bytes(b"junk")
    (d / "y.mp4").write_bytes(b"also junk")
    return d


@pytest.mark.parametrize("case", ["missing_model", "no_videos", "vctaot", "not_square",
                                  "all_skipped", "systemic"])
def test_caption_directory_keeps_vcts_errors(setup, tmp_path, monkeypatch, case):
    _, dst, vids, _ = setup
    kw = dict(height=SIZE, width=SIZE, device="cpu")
    if case == "missing_model":
        with pytest.raises(FileNotFoundError, match="no such file"):
            infer.caption_directory(str(tmp_path / "nope"), str(vids), **kw)
    elif case == "no_videos":
        with pytest.raises(ValueError, match="no videos matching"):
            infer.caption_directory(dst, str(vids), video_ext=".avi", **kw)
    elif case == "vctaot":
        art = tmp_path / "c.vctaot"
        art.write_bytes(b"an artifact")
        with pytest.raises(ValueError, match=r"ROADMAP Queue 1 item 7 \(b\)"):
            infer.caption_directory(str(art), str(vids), **kw)
        with pytest.raises(ValueError, match=r"item 7 \(b\)"):
            cli.main(["--caption_videos", str(vids), "--model", str(art), "--device", "cpu"])
    elif case == "not_square":
        with pytest.raises(ValueError, match="not square"):
            infer.caption_directory(dst, str(vids), height=SIZE, width=SIZE + 8, device="cpu")
    elif case == "all_skipped":
        with pytest.raises(RuntimeError, match="all 2 videos"):
            infer.caption_directory(dst, str(_junk_dir(tmp_path)), **kw)
    else:
        from vct_torch.caption import data

        def broken(*a, **k):
            raise ImportError("No module named cv2")

        monkeypatch.setattr(data, "extract_frames_interval", broken)
        with pytest.raises(ImportError):
            infer.caption_directory(dst, str(vids), **kw)


def test_listing_and_chunk_decoders_are_vcts(setup, capsys):
    _, _, vids, _ = setup
    for ext in (None, ".mp4", ".MP4", ".avi"):
        assert infer._list_videos(str(vids), ext) == vct_infer._list_videos(str(vids), ext)
    assert infer._skip_errors() == vct_infer._skip_errors()
    paths = infer._list_videos(str(vids), None)
    want = vct_infer._decode_chunk(paths, 3, SIZE)
    want_out = capsys.readouterr().out
    got = infer._decode_chunk(paths, 3, SIZE)
    assert capsys.readouterr().out == want_out and got[1] == want[1] and len(got[1]) == 5
    assert all(np.array_equal(a, b) and a.dtype == np.float32 for a, b in zip(got[0], want[0]))
    for raw_len in (5, 8):  # vid3 (9 frames) over capacity at both: interval-extracted
        want = vct_infer._decode_chunk_raw(paths, raw_len, SIZE, target_frames=3)
        got = infer._decode_chunk_raw(paths, raw_len, SIZE, target_frames=3)
        assert got[1] == want[1] and got[2] == want[2]
        assert all(np.array_equal(a, b) for a, b in zip(got[0], want[0]))


def test_restore_caption_trainer_relative_path(setup, monkeypatch):
    _, dst, _, _ = setup
    monkeypatch.chdir(os.path.dirname(dst))
    _, state, cfg = restore_caption_trainer(os.path.basename(dst), device="cpu")
    assert cfg.num_frames == common.T and state.step == 0


@pytest.mark.parametrize("argv,message", [
    (["--caption_videos", "d"], "usage: python -m vct_torch.caption --caption_videos"),
    (["--caption_videos", "d", "--model", "m", "--eval"], "Unknown arguments"),
    (["--caption_videos", "d", "--model", "m", "--epochs", "2"], "Unknown arguments"),
    (["--video_dir", "d"], "usage: python -m vct_torch.caption --video_dir"),
    (["--annotations", "a.txt"], "usage: python -m vct_torch.caption --video_dir"),
])
def test_cli_file_modes_refuse_what_vct_refuses(capsys, argv, message):
    assert cli.main(argv) == 2
    assert message in capsys.readouterr().out
    assert vct_cli.main(list(argv)) == 2


SMALL_ARGS = ["--backbone", "resnet18", "--cnn_output_size", "16", "--hidden_size", "16",
              "--num_frames", "3", "--max_caption_len", "6", "--epochs", "2",
              "--batch_size", "2", "--device", "cpu"]


@pytest.mark.parametrize("feature_cache", [False, True])
def test_cli_trains_from_files_and_prints_vcts_lines(setup, tmp_path, capsys, feature_cache):
    _, _, _, ann = setup
    ck = tmp_path / "ck"
    rc = cli.main(["--video_dir", str(ann.parent), "--annotations", str(ann), "--eval", "--checkpoint_dir", str(ck), *SMALL_ARGS]
                  + (["--feature_cache"] if feature_cache else []))
    out = capsys.readouterr().out
    assert rc == 0, out
    lines = out.splitlines()
    assert "Vocabulary size: 11; dataset: 6 clips (lazy)" in lines
    assert [l.split(",")[0] for l in lines if l.startswith("Epoch [")] == \
        ["Epoch [1/2]", "Epoch [2/2]"]
    assert "Error processing broken.avi" in out
    assert sum(l.startswith("Average BLEU score: ") for l in lines) == 1
    assert "inference_duration: " in out and out.count("Caption:") == 1
    assert ("feature_cache: extracted" in out) == feature_cache
    losses = json.loads(lines[[l.startswith("Epoch [2/2]") for l in lines].index(True) + 2])
    assert len(losses) == 2 and all(np.isfinite(losses))
    manifest = json.loads((ck / "manifest.json").read_text())
    assert manifest["framework"] == "vct_torch" and manifest["epoch"] == 2
