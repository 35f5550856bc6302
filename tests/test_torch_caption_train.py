"""vct_torch's caption trainer on the CPU: ``fit`` against vct's, and the
trainer's own behaviour.

At the small size of tests/torch_caption_common.py, one seeded variables
tree in both (through the bridge), dropout 0: ``fit``'s epoch and val losses
within rtol 1e-5 of vct's (the loss, its gradients and five Adam steps are
held in tests/test_torch_caption_grads.py and test_torch_caption_adam.py).
Then a run crashed between epochs resumes bit for bit,
``restore_caption_trainer`` round-trips, a vct checkpoint is refused naming
the converter, and the CLI (``python -m vct_torch.caption --synthetic``)
trains and prints the metric lines (its file modes:
tests/test_torch_caption_infer.py).
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_caption_common as common
from vct.caption import train as vct_train
from vct_torch.bridge import load_vct_variables
from vct_torch.caption import __main__ as cli
from vct_torch.caption.train import CaptionTrainer, restore_caption_trainer


def test_fit_epoch_and_val_losses_match_vct(tmp_path, capsys):
    """Two epochs of ``fit`` (feature cache on, a val set, no checkpoint
    directory) print vct's lines and give its epoch and val losses; the
    history JSON and the step lines (``log_every``) are written."""
    history = str(tmp_path / "history.json")
    extra = dict(learning_rate=1e-3, epochs=2, feature_cache=True, checkpoint_dir="")
    _, variables, _, cfg_t = common.pair("s2vt", **extra)
    cfg_v, _ = common.configs("s2vt", **extra)
    videos, captions = common.inputs(n=5)
    val = common.inputs(seed=1, n=3)
    vct_trainer = vct_train.CaptionTrainer(cfg_v, common.vocab())
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    state_v = vct_train.CaptionState(
        step=jnp.zeros((), jnp.int32), params=params,
        extra_vars={k: jax.tree_util.tree_map(jnp.asarray, v) for k, v in variables.items()
                    if k != "params"},
        opt_state=vct_trainer._tx.init(params), rng=jax.random.PRNGKey(0))
    _, want = vct_trainer.fit(state_v, videos, captions, batch_size=2, val=val)
    want_out = capsys.readouterr().out
    trainer = CaptionTrainer(dataclasses.replace(cfg_t, history_path=history, log_every=1),
                             common.vocab(), device="cpu")
    load_vct_variables(trainer.model, variables)
    state, got = trainer.fit(trainer.init_state(), videos, captions, batch_size=2, val=val)
    out = capsys.readouterr().out
    np.testing.assert_allclose(got, want, rtol=1e-5)
    vals = lambda text: [float(l.split()[-1]) for l in text.splitlines()  # noqa: E731
                         if l.startswith("Validation Loss:")]
    np.testing.assert_allclose(vals(out), vals(want_out), atol=1e-4)
    assert [l for l in out.splitlines() if l.startswith("Epoch [")][0].startswith("Epoch [1/2]")
    assert sum(l.startswith("step ") for l in out.splitlines()) == 6 and state.step == 6
    saved = json.load(open(history))
    assert len(saved["train_loss"]) == 2 and len(saved["val_loss"]) == 2
    assert saved["step_times"]["steps"] == 6


@pytest.mark.parametrize("feature_cache", [False, True])
def test_resume_after_a_crash_is_bit_equal(tmp_path, feature_cache):
    """Dropout on: three epochs straight, against one epoch, a crash, and a
    new trainer resuming to three from the checkpoint (weights, Adam,
    step, dropout generator, shuffle stream, history)."""
    _, cfg = common.configs("s2vt", dropout=0.3, learning_rate=1e-3, epochs=3,
                            feature_cache=feature_cache)
    videos, captions = common.inputs(n=5)
    straight = CaptionTrainer(cfg, common.vocab(), device="cpu", seed=3)
    s1, losses = straight.fit(straight.init_state(), videos, captions, batch_size=2,
                              checkpoint_dir=str(tmp_path / "a"), log=False)
    first = CaptionTrainer(dataclasses.replace(cfg, epochs=1), common.vocab(), device="cpu",
                           seed=3)
    first.fit(first.init_state(), videos, captions, batch_size=2,
              checkpoint_dir=str(tmp_path / "b"), log=False)
    resumed = CaptionTrainer(cfg, common.vocab(), device="cpu", seed=9)  # another init
    s2, resumed_losses = resumed.fit(resumed.init_state(), videos, captions, batch_size=2,
                                     checkpoint_dir=str(tmp_path / "b"), log=False)
    assert resumed_losses == losses and s2.step == s1.step == 9
    for (n, a), (_, b) in zip(s1.model.state_dict().items(), s2.model.state_dict().items()):
        assert torch.equal(a, b), n
    assert torch.equal(s1.generator.get_state(), s2.generator.get_state())


def test_restore_caption_trainer_round_trips_and_refuses_vct(tmp_path):
    _, cfg = common.configs("transformer", epochs=1, learning_rate=1e-3)
    videos, captions = common.inputs()
    trainer = CaptionTrainer(cfg, common.vocab(), device="cpu")
    state, _ = trainer.fit(trainer.init_state(), videos, captions, batch_size=2,
                           checkpoint_dir=str(tmp_path), log=False)
    restored, r_state, r_cfg = restore_caption_trainer(str(tmp_path), device="cpu")
    assert r_cfg == cfg and restored.vocab.word2idx == trainer.vocab.word2idx
    assert r_state.step == state.step
    for (n, a), (_, b) in zip(state.model.state_dict().items(),
                              r_state.model.state_dict().items()):
        assert torch.equal(a, b), n
    assert restored.caption_videos(r_state, videos) == trainer.caption_videos(state, videos)
    manifest = json.load(open(tmp_path / "manifest.json"))
    assert manifest["framework"] == "vct_torch" and manifest["epoch"] == 1
    del manifest["framework"]  # vct's caption manifests carry none
    (tmp_path / "manifest.json").write_text(json.dumps(manifest))
    with pytest.raises(ValueError, match="python convert_vct_checkpoint.py SRC DST"):
        restore_caption_trainer(str(tmp_path), device="cpu")


SMALL_ARGS = ["--backbone", "resnet18", "--cnn_output_size", "16", "--hidden_size", "16",
              "--num_frames", "3", "--max_caption_len", "6", "--epochs", "2"]


@pytest.mark.parametrize("kind", ["s2vt", "transformer"])
def test_cli_synthetic_prints_the_metric_lines(tmp_path, capsys, kind):
    rc = cli.main(["--synthetic", "--device", "cpu", "--model_kind", kind, "--checkpoint_dir",
                   str(tmp_path), "--eval", *SMALL_ARGS])
    out = capsys.readouterr().out
    assert rc == 0
    assert sum(l.startswith("Epoch [") for l in out.splitlines()) == 2
    assert "Average BLEU score: " in out and "inference_duration: " in out
    assert out.count("Caption:") == 2
    assert json.load(open(tmp_path / "manifest.json"))["config"]["model_kind"] == kind


def test_cli_refuses_unknown_flags_and_needs_the_card_by_default(monkeypatch, capsys):
    assert cli.main(["--synthetic", "--bogus", "1"]) == 2
    assert "Unknown arguments" in capsys.readouterr().out
    assert cli.main([]) == 2
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["--synthetic", *SMALL_ARGS])
