"""vct_torch's host data path against vct's, on the CPU: the host samplers,
decode (cv2 and the native ffmpeg decoder), the process-pool decoder, frame
directories, the clip cache and its loaders, and ingest.

The videos are small mp4 files written here with cv2 (no fixture is in the
repo). Every comparison is exact: the same selected frames, ties included,
the same decoded pixels, caches equal byte for byte.
"""

from __future__ import annotations

import os
import sys
from pathlib import Path

import numpy as np
import pytest

from vct.core import config as vct_config
from vct.data import clipcache as vct_clipcache
from vct.data import frames as vct_frames
from vct.data import ingest as vct_ingest
from vct.data import loaders as vct_loaders
from vct.data import samplers as vct_samplers
from vct.data import video as vct_video
from vct_torch.core import config
from vct_torch.data import clipcache, frames, ingest, loaders, samplers, video, videodec

cv2 = pytest.importorskip("cv2")

REPO = Path(__file__).resolve().parent.parent
HW = 24
T = 5


def write_video(path, frames_bgr, fps=10.0):
    """An mp4 (mp4v) of ``frames_bgr`` (uint8 (n, H, W, 3), BGR)."""
    h, w = frames_bgr.shape[1:3]
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    assert writer.isOpened()
    for f in frames_bgr:
        writer.write(np.ascontiguousarray(f))
    writer.release()


def write_dataset(root, counts=((9, 14, 4), (11, 7, 16)), size=32, seed=0):
    """Class directories ``c0``, ``c1`` of mp4 files with the given frame
    counts (some shorter than T, some longer), plus a file that is not a
    video under a video name in ``c1``. Returns ``root``."""
    rng = np.random.RandomState(seed)
    for ci, lengths in enumerate(counts):
        d = Path(root) / f"c{ci}"
        d.mkdir(parents=True)
        for vi, n in enumerate(lengths):
            write_video(d / f"v{vi}.mp4", rng.randint(0, 256, (n, size, size, 3), np.uint8))
    (Path(root) / "c1" / "broken.mp4").write_bytes(b"not a video")
    return str(root)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    return write_dataset(tmp_path_factory.mktemp("videos"))


def _configs(tmp, **kw):
    """(vct's Config, the port's) with the same overrides, except that vct
    decodes in one process: its pool forks, and a fork of a process running
    JAX's threads can deadlock; the port's pool (spawned) takes 2 workers."""
    over = {"data.img_height": str(HW), "data.img_width": str(HW),
            "data.sequence_length": str(T), "data.processed_data_path": str(tmp),
            "model.num_classes": "2", "train.batch_size": "2"}
    over.update(kw)
    return (vct_config.Config().replace(**over, **{"data.decode_workers": "1"}),
            config.Config().replace(**over, **{"data.decode_workers": "2"}))


# ---------------------------------------------------------------------------
# host samplers


def _clips_for_selection():
    """Random frames, a static clip (every score ties) and a clip of two
    alternating frames (every transition ties at a nonzero score)."""
    rng = np.random.RandomState(3)
    noise = list(rng.randint(0, 256, (13, 10, 12, 3), np.uint8))
    static = [np.full((10, 12, 3), 7, np.uint8) for _ in range(11)]
    a, b = rng.randint(0, 256, (2, 10, 12, 3), np.uint8)
    alternating = [(a if i % 2 else b).copy() for i in range(12)]
    short = noise[:3]
    return {"noise": noise, "static": static, "alternating": alternating, "short": short}


def _indices(frames_in, frames_out):
    """Which input frames (by identity) a sampler returned, in order."""
    ids = [id(f) for f in frames_in]
    return [ids.index(id(f)) for f in frames_out]


@pytest.mark.parametrize("method", sorted(vct_samplers.SAMPLERS))
def test_every_sampler_selects_vcts_frames_ties_included(method):
    assert set(samplers.SAMPLERS) == set(vct_samplers.SAMPLERS)
    for name, clip in _clips_for_selection().items():
        want = _indices(clip, vct_samplers.sample_frames(clip, T, method))
        got = _indices(clip, samplers.sample_frames(clip, T, method))
        assert got == want, (method, name)
        assert len(got) == T


def test_flow_proxy_without_cv2_selects_vcts_frames(monkeypatch):
    """Where cv2 does not import, both take the difference-energy proxy."""
    monkeypatch.setattr(vct_samplers, "_HAS_CV2", False)
    monkeypatch.setitem(sys.modules, "cv2", None)
    for name, clip in _clips_for_selection().items():
        want = _indices(clip, vct_samplers.optical_flow_sampling(clip, T))
        got = _indices(clip, samplers.optical_flow_sampling(clip, T))
        assert got == want, name


@pytest.mark.parametrize("win", [3, 7])
def test_ssim_pair_equals_vcts(win):
    rng = np.random.RandomState(4)
    a, b = rng.randint(0, 256, (2, 11, 9, 3), np.uint8)
    assert samplers.ssim_pair(a, b, win) == vct_samplers.ssim_pair(a, b, win)
    assert samplers.ssim_pair(a[..., 0], b[..., 0], win) == \
        vct_samplers.ssim_pair(a[..., 0], b[..., 0], win)


def test_unknown_method_raises_as_vct():
    with pytest.raises(KeyError, match="Unknown sampling method"):
        samplers.sample_frames([np.zeros((2, 2, 3))], T, "nope")


# ---------------------------------------------------------------------------
# decode


def _video_files(root):
    return sorted(str(p) for p in Path(root).glob("c*/v*.mp4"))


@pytest.mark.parametrize("decoder", ["cv2", "native", "auto"])
def test_decode_video_is_vcts_pixels(dataset, decoder):
    if decoder == "native" and not videodec.is_available():
        pytest.fail("the native decoder must build where the ffmpeg libraries are")
    for path in _video_files(dataset):
        for h, w in ((HW, HW), (32, 32), (20, 28)):
            want = vct_video.decode_video(path, h, w, decoder=decoder)
            got = video.decode_video(path, h, w, decoder=decoder)
            assert len(got) == len(want) > 0
            assert all(g.dtype == np.uint8 and np.array_equal(g, x) for g, x in zip(got, want))
    path = _video_files(dataset)[0]
    assert len(video.decode_video(path, HW, HW, max_frames=3, decoder=decoder)) == 3


def test_native_decoder_builds_beside_the_checkout_not_the_source():
    lib = Path(videodec.build_library())
    assert lib.parent.parent == REPO / ".vct_torch_build"
    assert lib.parent.name.startswith("host-")
    cc = clipcache.build_host_library("clipcache.cpp", clipcache._FLAGS)
    assert cc.parent.parent == REPO / ".vct_torch_build" and cc.name == "libclipcache.so"
    assert sorted(os.listdir(REPO / "vct_torch" / "native")) == ["clipcache.cpp",
                                                                 "videodec.cpp"]


@pytest.mark.parametrize("method", ["uniform", "uniform_seek", "sad", "ssim"])
@pytest.mark.parametrize("normalize", [True, False])
def test_decode_and_sample_equals_vct(dataset, method, normalize):
    for path in _video_files(dataset):
        want = vct_video.decode_and_sample(path, HW, HW, T, method, normalize)
        got = video.decode_and_sample(path, HW, HW, T, method, normalize)
        assert got.dtype == want.dtype and got.shape == (T, HW, HW, 3)
        assert np.array_equal(got, want)


def test_parallel_decoder_keeps_order_and_skips_bad_files(dataset):
    paths = sorted(str(p) for p in Path(dataset).glob("c*/*.mp4"))
    assert any(p.endswith("broken.mp4") for p in paths)
    errors = []
    out = list(video.ParallelDecoder(workers=2).decode_many(
        paths, HW, HW, T, "sad", normalize=False, on_error=lambda p, e: errors.append(p)))
    want = list(vct_video.ParallelDecoder(workers=1).decode_many(
        paths, HW, HW, T, "sad", normalize=False, on_error=lambda p, e: None))
    assert [p for p, _ in out] == [p for p, _ in want] == [p for p in paths
                                                            if not p.endswith("broken.mp4")]
    assert all(np.array_equal(a, b) for (_, a), (_, b) in zip(out, want))
    assert errors == [p for p in paths if p.endswith("broken.mp4")]
    serial = list(video.ParallelDecoder(workers=1).decode_many(paths, HW, HW, T, "sad",
                                                               normalize=False,
                                                               on_error=lambda p, e: None))
    assert all(np.array_equal(a, b) for (_, a), (_, b) in zip(out, serial))


def test_frame_directories_equal_vcts(tmp_path):
    rng = np.random.RandomState(6)
    for cls in ("fight", "calm"):
        d = tmp_path / "frames" / cls
        d.mkdir(parents=True)
        for vid, n in (("a_1", 7), ("b_2", 3)):
            for i in range(n):
                cv2.imwrite(str(d / f"{vid}_{i}.png"),
                            rng.randint(0, 256, (18, 22, 3), np.uint8))
    for method in ("uniform", "diff"):
        want = vct_frames.load_frames_dataset(str(tmp_path / "frames"), sequence_length=T,
                                              sampling_method=method, img_height=HW,
                                              img_width=HW)
        got = frames.load_frames_dataset(str(tmp_path / "frames"), sequence_length=T,
                                         sampling_method=method, img_height=HW, img_width=HW)
        assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
        assert got[2] == want[2]
    one = str(tmp_path / "frames" / "fight")
    assert np.array_equal(frames.preprocess_frames_dir(one, T, HW, HW),
                          vct_frames.preprocess_frames_dir(one, T, HW, HW))
    names = ["f10.png", "f2.png", "f1.png"]
    assert sorted(names, key=frames.natural_sort_key) == \
        sorted(names, key=vct_frames.natural_sort_key) == ["f1.png", "f2.png", "f10.png"]


# ---------------------------------------------------------------------------
# the clip cache


@pytest.mark.parametrize("labels", ["int", "float"])
def test_clip_cache_is_byte_equal_across_packages(tmp_path, labels):
    rng = np.random.RandomState(7)
    clips = rng.randint(0, 256, (7, 3, 6, 5, 3), np.uint8)
    y = (rng.randint(0, 4, 7).astype(np.int64) if labels == "int"
         else rng.rand(7, 4).astype(np.float32))
    vct_clipcache.write_clipcache(str(tmp_path / "vct.vctc"), clips, y)
    clipcache.write_clipcache(str(tmp_path / "port.vctc"), clips, y)
    assert (tmp_path / "vct.vctc").read_bytes() == (tmp_path / "port.vctc").read_bytes()
    for name in ("vct.vctc", "port.vctc"):
        path = str(tmp_path / name)
        for reader in (clipcache.ClipCacheLoader, vct_clipcache.ClipCacheLoader):
            with reader(path, 3, shuffle=False, workers=2) as loader:
                xs, ys = zip(*loader.epoch())
            assert np.array_equal(np.concatenate(xs), clips)
            assert np.array_equal(np.concatenate(ys), y)
        got = loaders.ClipCacheMapLoader(path, 3)
        want = vct_loaders.ClipCacheMapLoader(path, 3)
        for (a, b, m), (c, d, n) in zip(got.epoch(np.random.RandomState(1)),
                                        want.epoch(np.random.RandomState(1))):
            assert a.dtype == np.uint8 and np.array_equal(a, c)
            assert np.array_equal(b, d) and np.array_equal(m, n)


def test_native_loader_shuffles_and_replays_epochs_as_vcts(tmp_path):
    rng = np.random.RandomState(8)
    clips = rng.randint(0, 256, (10, 2, 3, 3, 3), np.uint8)
    path = clipcache.write_clipcache(str(tmp_path / "c.vctc"), clips, np.arange(10))

    def epochs(cls, start=0, n=3):
        with cls(path, 4, shuffle=True, seed=5, workers=2) as loader:
            if start:
                loader.set_epoch(start)
            return [np.concatenate([yb for _, yb in loader.epoch()]) for _ in range(n)]

    port = epochs(clipcache.ClipCacheLoader)
    assert [e.tolist() for e in port] == [e.tolist() for e in epochs(vct_clipcache.ClipCacheLoader)]
    assert all(sorted(e.tolist()) == list(range(10)) for e in port)
    assert port[0].tolist() != port[1].tolist()
    assert [e.tolist() for e in epochs(clipcache.ClipCacheLoader, start=1, n=2)] == \
        [e.tolist() for e in port[1:]]
    with clipcache.ClipCacheLoader(path, 4, shuffle=False, drop_last=True) as loader:
        assert loader.num_batches == 2 and [len(x) for x, _ in loader.epoch()] == [4, 4]
    stream = loaders.as_loader(clipcache.ClipCacheLoader(path, 4, shuffle=False))
    assert isinstance(stream, loaders.ClipCacheStream)
    rng, ref = np.random.RandomState(0), np.random.RandomState(0)
    batches = list(stream.epoch(rng))
    assert [m.sum() for _, _, m in batches] == [4, 4, 2]
    ref.permutation(10)  # the one draw an epoch every loader takes
    assert rng.randint(1 << 30) == ref.randint(1 << 30)
    stream.loader.close()


def test_truncated_caches_and_bad_clips_are_refused(tmp_path):
    rng = np.random.RandomState(9)
    path = tmp_path / "c.vctc"
    clipcache.write_clipcache(str(path), rng.randint(0, 256, (3, 2, 4, 4, 3), np.uint8),
                              np.arange(3))
    path.write_bytes(path.read_bytes()[:-10])
    with pytest.raises(IOError):
        loaders.ClipCacheMapLoader(str(path), 2)
    with pytest.raises(IOError):
        clipcache.ClipCacheLoader(str(path), 2)
    (tmp_path / "junk.vctc").write_bytes(b"\0" * 100)
    with pytest.raises(IOError, match="not a clip cache"):
        loaders.ClipCacheMapLoader(str(tmp_path / "junk.vctc"), 2)
    with clipcache.ClipCacheWriter(str(tmp_path / "w.vctc"), 2, 4, 4, 3) as writer:
        with pytest.raises(ValueError, match="clip shape"):
            writer.append(np.zeros((2, 4, 5, 3), np.uint8), 0)
    with clipcache.ClipCacheWriter(str(tmp_path / "f.vctc"), 2, 4, 4, 3, label_dim=3) as writer:
        with pytest.raises(ValueError, match="label shape"):
            writer.append(np.zeros((2, 4, 4, 3), np.uint8), np.zeros(2))
    with pytest.raises(IOError, match="could not open"):
        clipcache.ClipCacheWriter(str(tmp_path / "no" / "dir.vctc"), 2, 4, 4, 3)


def test_hdf5_loader_equals_vcts(tmp_path):
    h5py = pytest.importorskip("h5py")
    rng = np.random.RandomState(10)
    x = rng.rand(9, 2, 3, 3, 3).astype(np.float32)
    with h5py.File(tmp_path / "d.h5", "w") as hf:
        hf["videos"] = x
        hf["labels"] = rng.randint(0, 3, 9)
    idx = np.array([0, 2, 3, 5, 8])
    with loaders.HDF5Loader(str(tmp_path / "d.h5"), 2, idx) as got:
        with vct_loaders.HDF5Loader(str(tmp_path / "d.h5"), 2, idx) as want:
            assert got.clip_shape == want.clip_shape and got.num_examples == 5
            for a, b in zip(got.epoch(np.random.RandomState(2)),
                            want.epoch(np.random.RandomState(2))):
                assert all(np.array_equal(u, v) for u, v in zip(a, b))


# ---------------------------------------------------------------------------
# ingest


@pytest.mark.parametrize("cache_format", ["clipcache", "hdf5"])
@pytest.mark.parametrize("mode", ["multiclass", "multiple_binary"])
def test_ingest_writes_vcts_cache(dataset, tmp_path, cache_format, mode):
    over = {"data.cache_format": cache_format, "model.classif_mode": mode,
            "data.sampling_method": "sad", "data.dataset_path": dataset}
    cfg_v, _ = _configs(tmp_path / "vct", **over)
    _, cfg_t = _configs(tmp_path / "port", **over)
    vct_ingest.ensure_cache(cfg_v)
    ingest.ensure_cache(cfg_t)
    assert np.array_equal(np.load(cfg_t.data.classes_file), np.load(cfg_v.data.classes_file))
    assert Path(cfg_t.data.data_file).read_bytes() == Path(cfg_v.data.data_file).read_bytes()
    got, want = ingest.load_dataset_cache(cfg_t), vct_ingest.load_dataset_cache(cfg_v)
    assert all(np.array_equal(a, b) for a, b in zip(got[:2], want[:2])) and got[2] == want[2]
    assert loaders.cache_num_examples(cfg_t) == vct_loaders.cache_num_examples(cfg_v) == 6
    ingest.ensure_cache(cfg_t)  # an existing, compatible cache is reused


@pytest.mark.parametrize("change", [{"data.img_height": "16"},
                                    {"model.classif_mode": "multiple_binary"},
                                    {"model.num_classes": "3"}])
def test_stale_cache_is_refused_as_vct_refuses_it(dataset, tmp_path, change):
    cfg_v, cfg_t = _configs(tmp_path, **{"data.cache_format": "clipcache",
                                         "data.dataset_path": dataset})
    ingest.ensure_cache(cfg_t)
    stale_v, stale_t = cfg_v.replace(**change), cfg_t.replace(**change)
    with pytest.raises(ValueError) as want:
        vct_ingest.ensure_cache(stale_v)
    with pytest.raises(ValueError) as got:
        ingest.ensure_cache(stale_t)
    assert str(got.value) == str(want.value) and "stale" in str(got.value)


def test_missing_cache_without_a_dataset_path_raises(tmp_path):
    _, cfg_t = _configs(tmp_path)
    with pytest.raises(ValueError, match="data.dataset_path is empty"):
        ingest.ensure_cache(cfg_t)


def test_simple_and_inference_loads_equal_vcts(dataset):
    got = ingest.load_dataset_simple(dataset, HW, HW, T, decode_workers=2)
    want = vct_ingest.load_dataset_simple(dataset, HW, HW, T, decode_workers=1)
    assert all(np.array_equal(a, b) for a, b in zip(got[:2], want[:2])) and got[2] == want[2]
    c1 = os.path.join(dataset, "c1")
    for method in ("uniform", "ssim"):
        got = ingest.load_dataset_inference(c1, method, T, HW, HW, skip=["v0.mp4"],
                                            decode_workers=2)
        want = vct_ingest.load_dataset_inference(c1, method, T, HW, HW, skip=["v0.mp4"],
                                                 decode_workers=1)
        assert np.array_equal(got[0], want[0]) and got[1] == want[1] == ["v1.mp4", "v2.mp4"]
