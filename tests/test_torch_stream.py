"""Training from a dataset directory against vct, on the CPU: the streamed
session (``vct_torch.train.stream.stream_train_eval``), a loader fit against
an array fit, and ``python -m vct_torch.train`` with ``--data.dataset_path``
(in memory and ``--data.stream true``).

The mp4 dataset is written with cv2 (``test_torch_data.write_dataset``). Both
packages start from the same weights: Flax-shaped numpy variables from a seed
(``test_torch_train._random_variables``), carried into the port by the
bridge; each package's ``Trainer.init_state`` is wrapped to load them.
Tolerances: the streamed clips are uint8, normalized by division on the
port's side and by multiplication in vct's XLA (1 ulp apart), so losses and
metrics are held within rtol 1e-5; a loader fit and an array fit of the same
uint8 clips in the port are bit-equal.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from test_torch_data import write_dataset
from test_torch_train import NAMES, _captured, _overrides, _random_variables, _vct_state
from vct.core import config as vct_config
from vct.core.metrics_contract import extract_metrics as vct_extract_metrics
from vct.train import __main__ as vct_cli
from vct.train import engine as vct_engine
from vct.train import stream as vct_stream
from vct_torch.bridge import load_vct_variables
from vct_torch.core import config
from vct_torch.core.metrics_contract import extract_metrics
from vct_torch.data import ingest, loaders
from vct_torch.train import __main__ as cli
from vct_torch.train import engine
from vct_torch.train import stream
from vct_torch.train.checkpoint import load_checkpoint

pytest.importorskip("cv2")
T_SEQ, HW = 4, 32


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    return write_dataset(tmp_path_factory.mktemp("videos"), size=HW)


def _args(dataset, cache, **extra):
    kw = {**_overrides(rnn_type="gru"), "model.num_classes": "2",
          "data.dataset_path": dataset, "data.processed_data_path": str(cache),
          "data.cache_format": "clipcache", "data.decode_workers": "2",
          "data.sampling_method": "sad", "data.val_fraction": "0.34",
          "train.batch_size": "2", "train.epochs": "3", "train.learning_rate": "0.01",
          "train.early_stop_patience": "5"}
    kw.update(extra)
    return kw


def _same_start(monkeypatch, dataset, tmp_path):
    """Wrap both packages' ``init_state`` so each starts from one seeded set
    of variables."""
    cfg = vct_config.Config().replace(**_args(dataset, tmp_path / "shape"))
    shape_model = vct_engine.Trainer(cfg, NAMES[:2]).model
    variables = _random_variables(
        shape_model, np.zeros((1, T_SEQ, HW, HW, 3), np.float32), seed=1)
    monkeypatch.setattr(vct_engine.Trainer, "init_state",
                        lambda self, *a, **k: _vct_state(self, variables))
    port_init = engine.Trainer.init_state

    def init(self):
        state = port_init(self)
        load_vct_variables(self.model, variables)
        return state

    monkeypatch.setattr(engine.Trainer, "init_state", init)


def test_streamed_session_matches_vct(dataset, tmp_path, monkeypatch):
    _same_start(monkeypatch, dataset, tmp_path)
    over_v = _args(dataset, tmp_path / "vct", **{"train.model_path": str(tmp_path / "ck_v"),
                                                 "data.decode_workers": "1"})
    over_t = _args(dataset, tmp_path / "port", **{"train.model_path": str(tmp_path / "ck_t")})
    (_, want), out_v = _captured(vct_stream.stream_train_eval,
                                 vct_config.Config().replace(**over_v))
    (state, got), out_t = _captured(stream.stream_train_eval,
                                    config.Config().replace(**over_t), device="cpu")
    assert len(got.epoch_losses) == len(want.epoch_losses) == 3
    np.testing.assert_allclose(got.epoch_losses, want.epoch_losses, rtol=1e-5)
    assert got.epoch_accs == want.epoch_accs
    assert (got.accuracy, got.precision, got.recall, got.f1) == pytest.approx(
        (want.accuracy, want.precision, want.recall, want.f1), rel=1e-5)

    def first_lines(out):
        return [l for l in out.splitlines() if l.startswith(("Train:", "Found classes"))]

    assert first_lines(out_t) == [l.replace(str(tmp_path / "vct"), str(tmp_path / "port"))
                                  for l in first_lines(out_v)]
    state_dict, cfg, names, _ = load_checkpoint(str(tmp_path / "ck_t"))
    assert names == ["c0", "c1"] and cfg.data.cache_format == "clipcache"
    assert all(torch.equal(state_dict[k], v) for k, v in state.model.state_dict().items())


def test_loader_fit_equals_array_fit(dataset, tmp_path):
    """The streamed loader's uint8 batches (through ``fit_stream``, vct's
    alias of ``fit``) and an ArrayLoader of the same uint8 clips (through
    ``fit``) train the port bit-equal."""
    cfg = config.Config().replace(**_args(dataset, tmp_path))
    ingest.ensure_cache(cfg)
    train_idx, _ = loaders.split_indices(loaders.cache_num_examples(cfg), 0.34, 42)
    stream_loader = loaders.open_cache_loader(cfg, train_idx)
    x = np.asarray(stream_loader._clips)[train_idx]
    assert x.dtype == np.uint8
    runs = []
    for data in (stream_loader, loaders.ArrayLoader(x, stream_loader.labels, 2)):
        trainer = engine.Trainer(cfg, ["c0", "c1"], device="cpu")
        fit = trainer.fit_stream if data is stream_loader else trainer.fit
        state, run = _captured(fit, trainer.init_state(), data)[0]
        runs.append((run.epoch_losses, {k: v.clone() for k, v in state.model.state_dict().items()}))
    stream_loader.close()
    assert len(runs[0][0]) == 3 and runs[0][0] == runs[1][0]
    assert all(torch.equal(runs[0][1][k], runs[1][1][k]) for k in runs[0][1])


@pytest.mark.parametrize("streamed", [False, True])
def test_train_cli_from_a_dataset_directory_matches_vct(dataset, tmp_path, monkeypatch,
                                                        streamed):
    _same_start(monkeypatch, dataset, tmp_path)

    def argv(cache, ck, workers):
        kw = _args(dataset, cache, **{"data.stream": str(streamed).lower(),
                                      "train.model_path": str(ck),
                                      "data.decode_workers": workers})
        return [a for k, v in kw.items() for a in (f"--{k}", v)]

    # vct decodes in one process (its pool forks, unsafe under JAX's threads).
    rc_v, out_v = _captured(vct_cli.main, argv(tmp_path / "vct", tmp_path / "ck_v", "1"))
    rc_t, out_t = _captured(cli.main, ["--device", "cpu",
                                       *argv(tmp_path / "port", tmp_path / "ck_t", "2")])
    assert rc_v == rc_t == 0
    got, want = extract_metrics(out_t), vct_extract_metrics(out_v)
    for key in ("accuracy", "precision", "recall", "f1", "trainable_params"):
        assert getattr(got, key) == pytest.approx(getattr(want, key), rel=1e-5), key
    np.testing.assert_allclose(got.epoch_losses, want.epoch_losses, rtol=1e-5)
    assert [l for l in out_t.splitlines() if l.startswith("Train:")] == \
        [l.replace(str(tmp_path / "vct"), str(tmp_path / "port"))
         for l in out_v.splitlines() if l.startswith("Train:")]
    assert load_checkpoint(str(tmp_path / "ck_t"))[2] == ["c0", "c1"]
    assert dataclasses.asdict(got).keys() == dataclasses.asdict(want).keys()
