"""vct_torch's caption artifacts (``export_caption_servable``,
``CaptionAotServable``) against vct's, on the CPU.

The small S2VT and transformer captioners of tests/torch_caption_common.py,
one set of seeded weights carried from a vct variables tree into the port by
the bridge, are exported by both packages, dense and with the caption
pipeline's interval selection baked in (``device_sampling``, raw uint8 clips
and lengths). On the same clips the port's tokens equal vct's and its scores
are within 1e-5, as are those of the port's eager ``beam_search``. Then the
export CLI from a caption checkpoint, ``caption_directory`` and ``--caption_videos``
with an artifact against vct's, and the refusals.
"""

from __future__ import annotations

import json
import zipfile

import numpy as np
import pytest
import torch

import torch_caption_common as common
from vct.caption import infer as vct_infer
from vct.serve import aot as vct_aot
from vct_torch.caption import __main__ as cli
from vct_torch.caption import infer
from vct_torch.caption.beam import beam_search
from vct_torch.caption.train import CaptionTrainer
from vct_torch.caption.vocab import Vocabulary
from vct_torch.data.preprocess import device_sample_clips
from vct_torch.serve import aot

T, HW, MAX_LEN, K = common.T, common.HW, common.MAX_LEN, 3
RAW_LEN = 7
SHAPE = (T, HW, HW, 3)
N = 3  # one chunk: vct's bucket of 4, the port's smallest that fits of (2, 4)
CASES = [("s2vt", False), ("s2vt", True), ("transformer", False), ("transformer", True)]
IDS = [f"{k}-{'raw' if raw else 'dense'}" for k, raw in CASES]


@pytest.fixture(scope="module")
def captioners():
    return {kind: common.pair(kind) for kind in ("s2vt", "transformer")}


@pytest.fixture(scope="module")
def exported(captioners, tmp_path_factory):
    """Lazily exported (vct's artifact, the port's) for each case."""
    root = tmp_path_factory.mktemp("aotcap")
    vct_vocab = common.vocab()
    vocab = Vocabulary.from_dict(vct_vocab.to_dict())
    cache = {}

    def get(case):
        if case not in cache:
            kind, raw = case
            vct_model, variables, model, _ = captioners[kind]
            raw_len = RAW_LEN if raw else None
            tag = f"{kind}_{'raw' if raw else 'dense'}"
            paths = (str(root / f"{tag}_vct.vctaot"), str(root / f"{tag}.vctaot"))
            vct_aot.export_caption_servable(vct_model, variables, vct_vocab, SHAPE, paths[0],
                                            batch_sizes=(4,), beam_width=K, max_len=MAX_LEN,
                                            device_sampling=raw, raw_len=raw_len)
            aot.export_caption_servable(model, vocab, SHAPE, paths[1], batch_sizes=(2, 4),
                                        beam_width=K, max_len=MAX_LEN, device_sampling=raw,
                                        raw_len=raw_len)
            cache[case] = paths
        return cache[case]

    return get


def _inputs(raw):
    videos, _ = common.inputs(n=N)
    if not raw:
        return (videos,)
    rng = np.random.RandomState(5)
    frames = rng.randint(0, 256, (N, RAW_LEN, HW, HW, 3)).astype(np.uint8)
    return frames, np.array([RAW_LEN, 2, 5], np.int32)  # one shorter than T


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_caption_artifact_matches_vcts(captioners, exported, case):
    vct_path, path = exported(case)
    raw = case[1]
    arrays = _inputs(raw)
    want = vct_aot.CaptionAotServable.load(vct_path)
    sv = aot.CaptionAotServable.load(path, device="cpu")
    decode = (lambda s: s.decode_raw(*arrays)) if raw else (lambda s: s.decode(*arrays))
    tokens, scores = decode(sv)
    want_tokens, want_scores = decode(want)
    assert tokens.dtype == np.int32 and tokens.shape == (N, MAX_LEN + 1)
    np.testing.assert_array_equal(tokens, want_tokens)
    np.testing.assert_allclose(scores, want_scores, atol=1e-5)
    words = sv.caption_raw(*arrays) if raw else sv.caption(*arrays)
    assert words == (want.caption_raw(*arrays) if raw else want.caption(*arrays))
    # ... and the port's eager beam search on the same clips
    model = captioners[case[0]][2]
    x = torch.from_numpy(arrays[0])
    if raw:
        x = device_sample_clips(x, T, method="uniform", lengths=torch.from_numpy(arrays[1]),
                                short_pad="last")
    eager_tokens, eager_scores = beam_search(model, x, beam_width=K, max_len=MAX_LEN)
    np.testing.assert_array_equal(tokens, eager_tokens.numpy())
    np.testing.assert_allclose(scores, eager_scores.numpy(), atol=1e-6)


def test_caption_manifest_and_refusals(exported, tmp_path):
    _, path = exported(("s2vt", True))
    with zipfile.ZipFile(path) as zf:
        manifest = json.loads(zf.read("manifest.json"))
    vocab = manifest.pop("vocab")
    assert Vocabulary.from_dict(vocab).word2idx == common.vocab().word2idx
    assert manifest == {
        "format": "vct-torch-aot-caption-v1", "input_shape": list(SHAPE), "batch_sizes": [2, 4],
        "n_devices": 1, "beam_width": K, "max_len": MAX_LEN, "start_token": 1, "end_token": 2,
        "pad_token": 0, "device_sampling": True, "raw_len": RAW_LEN, "platform": "cpu",
        "torch_version": torch.__version__}
    sv = aot.CaptionAotServable.load(path, device="cpu")
    frames, lens = _inputs(True)
    with pytest.raises(ValueError, match="feed raw clips via decode_raw"):
        sv.decode(_inputs(False)[0])
    with pytest.raises(ValueError, match=r"lengths must be in \[1, raw_len=7\]"):
        sv.decode_raw(frames, np.array([RAW_LEN + 1, 2, 5], np.int32))
    tokens, scores = sv.decode_raw(frames[:0], lens[:0])
    assert tokens.shape == (0, MAX_LEN + 1) and scores.shape == (0,)
    with pytest.raises(ValueError, match="is a captioning artifact — load it with "
                                         "CaptionAotServable.load"):
        aot.AotServable.load(path, device="cpu")
    empty = tmp_path / "e.vctaot"
    empty.write_bytes(b"")
    with pytest.raises(ValueError, match="not a vct-torch-aot-caption-v1 artifact"):
        aot.CaptionAotServable.load(str(empty), device="cpu")
    m = aot.export_caption_servable
    model = None
    with pytest.raises(ValueError, match="beam_width must be >= 1"):
        m(model, None, SHAPE, str(tmp_path / "x"), beam_width=0)
    with pytest.raises(ValueError, match="raw_len only applies with device_sampling"):
        m(model, None, SHAPE, str(tmp_path / "x"), raw_len=8)
    with pytest.raises(ValueError, match="must exceed the sampled T"):
        m(model, None, SHAPE, str(tmp_path / "x"), device_sampling=True, raw_len=T)


@pytest.fixture(scope="module")
def caption_files(captioners, exported, tmp_path_factory):
    """(a vct_torch caption checkpoint of the S2VT weights, a directory of 4
    mp4 videos and a corrupt one)."""
    pytest.importorskip("cv2")
    root = tmp_path_factory.mktemp("capfiles")
    _, _, model, cfg = captioners["s2vt"]
    trainer = CaptionTrainer(cfg, Vocabulary.from_dict(common.vocab().to_dict()), device="cpu")
    state = trainer.init_state()
    state.model.load_state_dict(model.state_dict())
    ck = str(root / "ck")
    trainer.save_checkpoint(ck, state, 1, 1.0)
    vids = root / "vids"
    vids.mkdir()
    rng = np.random.RandomState(0)
    for i, n in enumerate([4, 6, 9, 5]):  # 9 frames: over RAW_LEN, extracted on the host
        common.write_video(vids / f"vid{i}.mp4", n, rng, HW + 8)
    (vids / "broken.mp4").write_bytes(b"not a video")
    return ck, str(vids)


def test_export_cli_for_a_caption_checkpoint(caption_files, exported, tmp_path, capsys):
    ck, vids = caption_files
    art = str(tmp_path / "c.vctaot")
    assert aot.main(["--model", ck, "--out", art, "--batches", "2", "--height", str(HW),
                     "--width", str(HW), "--device", "cpu"]) == 0
    assert capsys.readouterr().out.strip() == (
        f"exported {art}: caption platform=cpu buckets=[2] beam_width={K} max_len={MAX_LEN} "
        f"vocab={len(common.vocab())} words")
    # The CLI's artifact captions as the one exported in process.
    want = aot.CaptionAotServable.load(exported(("s2vt", False))[1], device="cpu")
    sv = aot.CaptionAotServable.load(art, device="cpu")
    clips = _inputs(False)[0]
    np.testing.assert_array_equal(sv.decode(clips)[0], want.decode(clips)[0])
    for argv, said in ((["--device_sampling", "sad"], "--device_sampling interval only"),
                       (["--raw_len", "8"], "--raw_len requires --device_sampling")):
        with pytest.raises(SystemExit):
            aot.main(["--model", ck, "--out", art, "--device", "cpu", *argv])
        assert said in capsys.readouterr().err


@pytest.mark.parametrize("raw", [False, True], ids=["dense", "raw"])
def test_caption_directory_with_an_artifact_matches_vcts(exported, caption_files, raw, capsys):
    _, vids = caption_files
    vct_path, path = exported(("s2vt", raw))
    want = vct_infer.caption_directory(vct_path, vids)
    want_out = capsys.readouterr().out
    got = infer.caption_directory(path, vids, device="cpu")
    assert got == want and len(got) == 4
    assert capsys.readouterr().out == want_out
    assert cli.main(["--caption_videos", vids, "--model", path, "--device", "cpu"]) == 0
    lines = [l for l in capsys.readouterr().out.splitlines() if "Generated Caption:" in l]
    assert lines == [l for l in want_out.splitlines() if "Generated Caption:" in l]


def _with_manifest(src, dst, **changes):
    with zipfile.ZipFile(src) as zin, zipfile.ZipFile(dst, "w") as zout:
        for item in zin.infolist():
            data = zin.read(item.filename)
            if item.filename == "manifest.json":
                data = json.dumps(json.loads(data) | changes).encode()
            zout.writestr(item, data)
    return str(dst)


@pytest.mark.parametrize("case", ["beam_width", "height", "width", "not_square"])
def test_caption_directory_refuses_what_the_artifact_does_not_bake(exported, caption_files,
                                                                     tmp_path, case):
    _, vids = caption_files
    _, path = exported(("s2vt", False))
    kw = {"beam_width": dict(beam_width=K + 1), "height": dict(height=HW + 8),
          "width": dict(width=HW + 8), "not_square": {}}[case]
    if case == "not_square":
        path = _with_manifest(path, tmp_path / "ns.vctaot", input_shape=[T, HW, HW + 8, 3])
    match = {"beam_width": f"bakes in beam_width={K}", "height": f"bakes in height={HW}",
             "width": f"bakes in width={HW}", "not_square": "is not square"}[case]
    with pytest.raises(ValueError, match=match):
        infer.caption_directory(path, vids, device="cpu", **kw)
