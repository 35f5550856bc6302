"""vct_torch's training slice (c) against vct's, on the CPU: resuming after
a crash, early-stopped and stale checkpoints, relative paths, the feature
cache after a restore, warm starts (``train.init_from``), the history JSON,
``train.log_every``'s step lines, ``StepTimer`` and ``train.profile_dir``.

A resumed run of the port is held bit-equal to its own uninterrupted run
(parameters, buffers, epoch and val losses), with dropout and the plateau
decay on, so the restored dropout generator, Adam moments, step count and
lowered learning rate all reach the result. Against vct (dropout 0: the
two frameworks' dropout streams cannot match) a resumed run's epoch and val
losses are within atol 1e-5 of vct's resumed run from the same weights.
"""

import json
import os

import numpy as np
import pytest
import torch

from test_torch_train import NAMES, T_SEQ, HW, CLASSES, _captured, _configs, _overrides, \
    _random_variables, _vct_state
from vct.train import engine as vct_engine
from vct.utils.profiling import StepTimer as VctStepTimer
from vct_torch.bridge import load_vct_variables
from vct_torch.core.config import Config
from vct_torch.data.batcher import train_test_split
from vct_torch.data.synthetic import generate_dummy_data
from vct_torch.models import init_weights
from vct_torch.train import __main__ as cli
from vct_torch.train import engine
from vct_torch.train.checkpoint import (
    load_checkpoint,
    load_train_state,
    save_checkpoint,
    save_train_state,
)
from vct_torch.utils.profiling import StepTimer, device_trace, write_history

# The plateau decay fires at epochs 2 and 3 by construction: a learning rate
# this small moves the val loss by far less than the plateau's 1e-6.
RESUME = {"model.dropout": "0.25", "train.lr_plateau_factor": "0.5",
          "train.lr_plateau_patience": "1", "train.learning_rate": "1e-11",
          "train.batch_size": "4"}


def _data(n=12, seed=1):
    x, y, _ = generate_dummy_data(num_samples=n, sequence_length=T_SEQ, height=HW, width=HW,
                                  num_classes=CLASSES, seed=seed)
    return x, y


def _fit(overrides, x, y, val=None, seed_init=None):
    """A fresh Trainer on the CPU (its weights from ``train.seed``, or from
    ``seed_init``) fitted on x, y; returns (trainer, state, run, stdout)."""
    trainer = engine.Trainer(Config().replace(**overrides), NAMES, device="cpu")
    if seed_init is not None:
        init_weights(trainer.model, seed_init)
    (state, run), out = _captured(trainer.fit, trainer.init_state(), x, y, val=val)
    return trainer, state, run, out


def _state_dict(module):
    return {k: v.clone() for k, v in module.state_dict().items()}


def _assert_bit_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("rnn_type", ["lstm", "mamba"])
def test_resume_after_a_crash_is_bit_equal_to_the_uninterrupted_run(tmp_path, rnn_type):
    base = {**_overrides(rnn_type=rnn_type), **RESUME}
    x, y = _data()
    val = (x[:4], y[:4])
    ref, _, run_ref, out_ref = _fit({**base, "train.epochs": "3"}, x, y, val)
    ckpt = {**base, "train.resume": "true", "train.model_path": str(tmp_path / "ck")}
    # Crash after epoch 1 (dropout and Adam's moments in the state), again
    # after epoch 2 (the plateau's lowered learning rate too), then resume to 3.
    _, _, run1, _ = _fit({**ckpt, "train.epochs": "1"}, x, y, val)
    _, _, _, out2 = _fit({**ckpt, "train.epochs": "2"}, x, y, val)
    trainer, state, run, out3 = _fit({**ckpt, "train.epochs": "3"}, x, y, val)
    assert "Resuming training from epoch 1" in out2 and "Resuming training from epoch 2" in out3
    decays = [l for l in out_ref.splitlines() if l.startswith("Reducing learning rate")]
    assert decays == ["Reducing learning rate to 5.000e-12", "Reducing learning rate to 2.500e-12"]
    assert decays[0] in out2 and decays[1] in out3
    assert state.optimizer.param_groups[0]["lr"] == 2.5e-12 and state.step == 9
    assert run.epoch_losses[:1] == run1.epoch_losses
    assert (run.epoch_losses, run.epoch_accs, run.val_losses) == \
        (run_ref.epoch_losses, run_ref.epoch_accs, run_ref.val_losses)
    _assert_bit_equal(_state_dict(trainer.model), _state_dict(ref.model))


def test_resumed_losses_match_vcts_resumed_run(tmp_path):
    overrides = {**_overrides(rnn_type="lstm"), "train.feature_cache": "true",
                 "train.learning_rate": "3e-3", "train.lr_plateau_factor": "0.5",
                 "train.lr_plateau_patience": "1", "train.resume": "true"}
    x, y = _data(16, seed=3)
    xt, xv, yt, yv = train_test_split(x, y, 0.25, 42)
    variables = _random_variables(vct_engine.Trainer(_configs(**overrides)[0], NAMES).model, xt)
    runs = {}
    for name, path in (("vct", tmp_path / "vct"), ("port", tmp_path / "port")):
        for epochs in ("1", "3"):
            cfg_v, cfg_t = _configs(**overrides, **{"train.epochs": epochs,
                                                    "train.model_path": str(path)})
            if name == "vct":
                trainer = vct_engine.Trainer(cfg_v, NAMES)
                state = _vct_state(trainer, variables)
            else:
                trainer = engine.Trainer(cfg_t, NAMES, device="cpu")
                load_vct_variables(trainer.model, variables)
                state = trainer.init_state()
            (_, run), out = _captured(trainer.fit, state, xt, yt, val=(xv, yv))
        runs[name] = (run, [l for l in out.splitlines()
                            if l.startswith(("Resuming", "Reducing"))])
    (run_v, lines_v), (run_t, lines_t) = runs["vct"], runs["port"]
    assert lines_t == lines_v and lines_t[0] == "Resuming training from epoch 1"
    assert len(run_t.epoch_losses) == 3
    np.testing.assert_allclose(run_t.epoch_losses, run_v.epoch_losses, atol=1e-5, rtol=0)
    np.testing.assert_allclose(run_t.val_losses, run_v.val_losses, atol=1e-5, rtol=0)
    assert run_t.epoch_accs == run_v.epoch_accs


def test_an_early_stopped_run_trains_no_further(tmp_path):
    cfg = {**_overrides(rnn_type="gru"), "train.epochs": "4", "train.resume": "true",
           "train.model_path": str(tmp_path / "ck"), "train.early_stop": "1e9"}
    x, y = _data(8)
    trainer1, _, run1, _ = _fit(cfg, x, y)
    assert len(run1.epoch_losses) == 1  # any loss stops
    stopped = _state_dict(trainer1.model)
    trainer2, state2, run2, out = _fit(cfg, x, y)
    assert "not training further" in out
    assert run2.epoch_losses == run1.epoch_losses and state2.step == 1
    _assert_bit_equal(_state_dict(trainer2.model), stopped)


def test_feature_cache_after_a_restore_reads_the_checkpoints_backbone(tmp_path):
    base = {**_overrides(rnn_type="lstm"), "train.feature_cache": "true", "train.resume": "true"}
    x, y = _data(16)
    _, _, run_full, _ = _fit({**base, "train.epochs": "2", "train.model_path": str(tmp_path / "a")},
                             x, y)
    ck = str(tmp_path / "ck")
    _fit({**base, "train.epochs": "1", "train.model_path": ck}, x, y)
    # A resuming process whose fresh weights came from another seed: only
    # the restored ones may reach epoch 2, the cached features included.
    _, _, run_res, out = _fit({**base, "train.epochs": "2", "train.model_path": ck}, x, y,
                              seed_init=123)
    assert "feature_cache: extracted" in out
    assert run_res.epoch_losses == run_full.epoch_losses


def _trained_state(tmp_path, **extra):
    x, y = _data(8)
    trainer, state, _, _ = _fit({**_overrides(rnn_type="gru", dropout=0.5), "train.epochs": "1",
                                 **extra}, x, y)
    return trainer, state


def test_stale_or_foreign_manifests(tmp_path):
    trainer, state = _trained_state(tmp_path)
    before = _state_dict(trainer.model)
    path = tmp_path / "ck"
    path.mkdir()
    manifest = {"framework": "vct_torch", "epoch": 3, "config": {}, "class_names": []}
    (path / "train_manifest.json").write_text(json.dumps(manifest))
    (got, epoch, extra), out = _captured(load_train_state, str(path), state)
    assert got is state and (epoch, extra) == (0, {}) and "starting from epoch 0" in out
    _assert_bit_equal(_state_dict(trainer.model), before)
    assert load_train_state(str(tmp_path / "nothing_here"), state) == (state, 0, {})
    del manifest["framework"]  # as vct writes it
    (path / "train_manifest.json").write_text(json.dumps(manifest))
    with pytest.raises(ValueError, match="written by None"):
        load_train_state(str(path), state)


def test_train_state_roundtrip_with_a_relative_path(tmp_path, monkeypatch):
    trainer, state = _trained_state(tmp_path, **{"train.lr_plateau_factor": "0.5"})
    trainer._scale_learning_rate(state, 0.5)
    monkeypatch.chdir(tmp_path)
    gen_state = state.generator.get_state()
    save_train_state("rel/ck", state, trainer.cfg, NAMES, 1, extra={"plateau_bad": 0})
    assert sorted(os.listdir("rel/ck")) == ["train_manifest.json", "train_state.pt"]
    fresh = engine.Trainer(trainer.cfg.replace(**{"train.seed": "7"}), NAMES, device="cpu")
    restored, epoch, extra = load_train_state("rel/ck", fresh.init_state())
    assert (epoch, extra, restored.step) == (1, {"plateau_bad": 0}, state.step)
    _assert_bit_equal(_state_dict(fresh.model), _state_dict(trainer.model))
    assert torch.equal(restored.generator.get_state(), gen_state)
    want, got = state.optimizer.state_dict(), restored.optimizer.state_dict()
    assert got["param_groups"] == want["param_groups"]
    for k, moments in want["state"].items():
        for name, value in moments.items():
            assert torch.equal(got["state"][k][name], value), (k, name)


def test_init_from_starts_from_the_saved_weights(tmp_path):
    trainer, state = _trained_state(tmp_path)
    cfg = trainer.cfg
    ckpt = save_checkpoint(str(tmp_path / "warm"), state.model.state_dict(), cfg, NAMES)
    warm = engine.Trainer(cfg.replace(**{"train.init_from": ckpt, "train.seed": "123"}), NAMES,
                          device="cpu")
    assert not torch.equal(warm.model.head.fcb.weight, trainer.model.head.fcb.weight)
    warm.init_state()
    _assert_bit_equal(_state_dict(warm.model), load_checkpoint(ckpt)[0])
    other = cfg.replace(**{"model.hidden_size": "7", "train.init_from": ckpt})
    with pytest.raises(ValueError, match="init_from shape mismatch"):
        engine.Trainer(other, NAMES, device="cpu").init_state()
    with pytest.raises(FileNotFoundError):
        engine.Trainer(cfg.replace(**{"train.init_from": str(tmp_path / "none")}), NAMES,
                       device="cpu").init_state()


def test_history_json_step_lines_and_trace(tmp_path):
    history = str(tmp_path / "h" / "history.json")
    x, y = _data(16)
    overrides = {**_overrides(rnn_type="lstm"), "train.epochs": "2", "train.batch_size": "8",
                 "train.log_every": "1", "train.history_path": history,
                 "train.profile_dir": str(tmp_path / "trace")}
    _, state, run, out = _fit(overrides, x, y)
    steps = [l for l in out.splitlines() if l.startswith("step ")]
    assert [l.split(":")[0] for l in steps] == ["step 1", "step 2", "step 3", "step 4"]
    assert all(l.endswith(" ms/step)") for l in steps)
    hist = json.load(open(history))
    assert hist["train_loss"] == run.epoch_losses and len(hist["train_loss"]) == 2
    assert hist["step_times"]["steps"] == 4 and hist["val_loss"] == []
    assert hist["config"]["model"]["rnn_type"] == "lstm"
    assert set(hist) == {"train_loss", "train_acc", "val_loss", "training_duration",
                         "step_times", "config"}
    traces = os.listdir(tmp_path / "trace")  # the first epoch only
    assert len(traces) == 1 and traces[0].endswith(".pt.trace.json")
    events = json.load(open(tmp_path / "trace" / traces[0]))["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)


def test_device_trace_is_a_no_op_without_a_directory(tmp_path):
    with device_trace("", "cpu"):
        pass
    with device_trace(None):
        pass
    with device_trace(str(tmp_path / "t"), "cpu"):
        torch.ones(3).sum()
    assert len(os.listdir(tmp_path / "t")) == 1


def test_step_timer_and_history_match_vct(tmp_path):
    summaries = []
    for timer in (StepTimer(), VctStepTimer()):
        timer.start()  # a span of 2 steps, then one of 1: 3 samples
        timer.step()
        timer.step()
        timer.sync()
        timer.start()
        timer.step()
        timer.sync()
        timer.start()  # a span with no sync records nothing
        timer.step()
        summaries.append(timer.summary())
        assert timer.last_ms == timer.times[-1] * 1e3
    assert summaries[0]["steps"] == summaries[1]["steps"] == 3
    assert set(summaries[0]) == set(summaries[1])
    assert StepTimer().summary() == VctStepTimer().summary() == {"steps": 0}
    write_history(str(tmp_path / "h.json"), {"train_loss": [1.0, 0.5], "step_times": summaries[0]})
    assert json.loads((tmp_path / "h.json").read_text())["train_loss"] == [1.0, 0.5]


def test_cli_resumes_and_passes_the_options_through(tmp_path):
    argv = ["--device", "cpu", "--data.synthetic", "true", "--data.synthetic_samples", "10",
            *[a for k, v in _overrides(rnn_type="gru").items() for a in (f"--{k}", v)],
            "--train.batch_size", "4", "--train.resume", "true",
            "--train.model_path", str(tmp_path / "ck"),
            "--train.history_path", str(tmp_path / "h.json")]
    rc, out1 = _captured(cli.main, argv + ["--train.epochs", "1"])
    rc2, out2 = _captured(cli.main, argv + ["--train.epochs", "2", "--train.log_every", "2"])
    assert rc == rc2 == 0
    assert "Resuming training from epoch 1" in out2 and "Epoch 1/2" not in out2
    assert [l.split(":")[0] for l in out2.splitlines() if l.startswith("step ")] == ["step 4"]
    assert len(json.load(open(tmp_path / "h.json"))["train_loss"]) == 2
    assert sorted(os.listdir(tmp_path / "ck")) == ["manifest.json", "train_manifest.json",
                                                   "train_state.pt", "weights.pt"]
