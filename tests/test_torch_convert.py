"""``convert_vct_checkpoint.py`` on the CPU: vct's three checkpoint forms,
written by vct's own savers, converted into vct_torch's and read by the port.

- A model checkpoint of each family the bridge covers (the deployed LRCN's
  Mamba head, an LSTM head, VideoMamba, ``lrcn2``, ``td_cnn_lstm``) served by
  the port's ``load_model`` within 1e-4 of vct's ``load_model`` logits.
- A train state (adam, adamw, sgd) and a caption state (and a legacy caption
  tree without rng/step): Adam's moments equal vct's after the bridge's
  transposes, by parameter name; the step, the plateau-lowered learning rate,
  the epoch and the trainer's counters carried; no dropout generator.
- Resumed for one epoch with dropout 0, a converted train state and caption
  state end within 1e-5 (of each tensor's largest) of vct's own resumed epoch;
  a train state vct saved on a (4, 2) mesh converts bit for bit and resumes
  alike on a (2, 2) world of CPU ranks and on one process.
- The converter's refusals, with nothing written.
"""

import copy
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import convert_vct_checkpoint as convert
import torch_caption_common as common
from test_torch_train import NAMES, T_SEQ, HW, _captured, _configs, _overrides, \
    _random_variables, _vct_state
from vct.caption import train as vct_caption
from vct.serve import deployment as vct_deployment
from vct.train import checkpoint as vct_checkpoint
from vct.train import engine as vct_engine
from vct_torch.bridge import load_vct_variables
from vct_torch.caption.train import CaptionTrainer, restore_caption_trainer
from vct_torch.serve.deployment import load_model
from vct_torch.train import engine

TOL = 1e-5
# The attention's key biases have an exactly zero gradient: their Adam steps
# follow f32 noise (tests/test_torch_caption_adam.py), held within 2 lr a step.
ZERO_GRADIENT = ".key.bias"

FAMILIES = {
    "lrcn_mamba": _overrides(rnn_type="mamba"),
    "lrcn_lstm": _overrides(rnn_type="lstm"),
    "videomamba": _overrides(model_family="videomamba", vm_n_layer=2, vm_d_model=32,
                             vm_d_inner=64, vm_n_state=16, vm_dt_rank=16),
    "lrcn2": _overrides(model_family="lrcn2"),
    "td_cnn_lstm": _overrides(model_family="td_cnn_lstm"),
}


def _sample():
    return np.random.RandomState(1).rand(2, T_SEQ, HW, HW, 3).astype(np.float32)


def _unmask(tree, params):
    """An optax moment tree with the frozen (masked) subtrees taken from
    ``params``, so the bridge can lay out the whole tree."""
    if isinstance(tree, optax.MaskedNode):
        return jax.tree_util.tree_map(np.asarray, params)
    if isinstance(tree, dict):
        return {k: _unmask(tree[k], params[k]) for k in params}
    return np.asarray(tree)


def _in_port_layout(model, tree, params, stats):
    clone = copy.deepcopy(model)
    load_vct_variables(clone, {"params": _unmask(tree, params), **stats})
    return {n: p.detach() for n, p in clone.named_parameters()}


def _random_moments(opt_state, count, seed=3):
    """``opt_state`` with its Adam state's moments drawn from a seed and its
    count set: nonzero moments show a mapping that drops or transposes one."""
    rng = np.random.RandomState(seed)

    def fill(s):
        if not isinstance(s, optax.ScaleByAdamState):
            return s
        draw = lambda l: jnp.asarray(rng.randn(*l.shape).astype(np.float32))  # noqa: E731
        return s._replace(count=jnp.asarray(count, s.count.dtype),
                          mu=jax.tree_util.tree_map(draw, s.mu),
                          nu=jax.tree_util.tree_map(lambda l: jnp.abs(draw(l)), s.nu))

    return jax.tree_util.tree_map(fill, opt_state,
                                  is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))


def _adam(opt_state):
    return [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]


def _assert_within_largest(got: dict, want: dict, lr_steps: float = 0.0):
    for name, w in want.items():
        if ZERO_GRADIENT in name:
            np.testing.assert_allclose(got[name].numpy(), w.numpy(), atol=2 * lr_steps, rtol=0,
                                       err_msg=name)
            continue
        scale = max(float(w.abs().max()), 1e-30)
        err = float((got[name] - w).abs().max())
        assert err <= TOL * scale, f"{name}: {err} > {TOL} x {scale}"


# ---------------------------------------------------------------------------
# model checkpoints


@pytest.mark.parametrize("family", list(FAMILIES))
def test_converted_model_serves_vcts_logits(tmp_path, family):
    cfg_v, _ = _configs(**FAMILIES[family])
    x = _sample()
    variables = _random_variables(vct_engine.build_model(cfg_v.model, T_SEQ), x)
    src = vct_checkpoint.save_checkpoint(str(tmp_path / "vct"), variables, cfg_v, NAMES,
                                         metrics={"accuracy": 0.5})
    dst = str(tmp_path / "port")
    assert convert.main([src, dst]) == 0
    model_v, variables_v, names_v, _ = vct_deployment.load_model(src)
    want = np.asarray(jax.jit(model_v.apply)(variables_v, jnp.asarray(x)))
    model, class_names, cfg = load_model(dst, device="cpu")
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    manifest = json.loads((tmp_path / "port" / "manifest.json").read_text())
    assert manifest["framework"] == "vct_torch" and class_names == names_v == NAMES
    assert manifest["metrics"] == {"accuracy": 0.5}
    assert manifest["config"] == cfg_v.to_dict() == cfg.to_dict()


# ---------------------------------------------------------------------------
# train states


@pytest.mark.parametrize("optimizer", ["adam", "adamw", "sgd"])
def test_train_state_maps_moments_step_and_learning_rate_by_name(tmp_path, capsys, optimizer):
    overrides = {**_overrides(rnn_type="mamba"), "train.optimizer": optimizer,
                 "train.weight_decay": "0.01", "train.grad_clip": "1.0"}
    cfg_v, cfg_t = _configs(**overrides)
    trainer_v = vct_engine.Trainer(cfg_v, NAMES)
    variables = _random_variables(trainer_v.model, _sample())
    state_v = _vct_state(trainer_v, variables)
    state_v = state_v.replace(opt_state=_random_moments(state_v.opt_state, 7),
                              step=jnp.asarray(7, jnp.int32))
    state_v, lowered = vct_engine._scale_learning_rate(state_v, 0.5)
    extra = {"best_loss": 0.25, "bad_epochs": 1, "plateau_best": 0.25, "plateau_bad": 0,
             "stopped": False, "epoch_losses": [0.5, 0.25], "epoch_accs": [0.1, 0.2],
             "val_losses": [0.6, 0.3]}
    src = vct_checkpoint.save_train_state(str(tmp_path / "vct"), state_v, cfg_v, NAMES, 2, extra)
    dst = tmp_path / "port"
    assert convert.main([src, str(dst)]) == 0
    assert "converted train_state" in capsys.readouterr().out
    saved = torch.load(dst / "train_state.pt", weights_only=True)
    manifest = json.loads((dst / "train_manifest.json").read_text())
    assert manifest["framework"] == "vct_torch" and manifest["epoch"] == 2
    assert manifest["extra"] == extra and manifest["class_names"] == NAMES
    assert saved["step"] == 7 and saved["generator"] is None
    assert lowered == pytest.approx(0.5 * cfg_v.train.learning_rate)
    assert [g["lr"] for g in saved["optimizer"]["param_groups"]] == [lowered]

    trainer = engine.Trainer(cfg_t, NAMES, device="cpu")
    names = {id(p): n for n, p in trainer.model.named_parameters()}
    order = [names[id(p)] for p in trainer._trained]
    params = jax.device_get(state_v.params)
    stats = jax.device_get(state_v.extra_vars)
    want_params = _in_port_layout(trainer.model, params, params, stats)
    for name, value in saved["model"].items():
        if name in want_params:
            assert torch.equal(value, want_params[name]), name
    adam = _adam(jax.device_get(state_v.opt_state))
    if optimizer == "sgd":
        assert not adam and not saved["optimizer"]["state"]
        return
    mu = _in_port_layout(trainer.model, adam[0].mu, params, stats)
    nu = _in_port_layout(trainer.model, adam[0].nu, params, stats)
    state = saved["optimizer"]["state"]
    assert sorted(state) == list(range(len(order)))
    assert not any(n.startswith("cnn_backbone.") for n in order)
    for i, name in enumerate(order):
        assert torch.equal(state[i]["exp_avg"], mu[name]), name
        assert torch.equal(state[i]["exp_avg_sq"], nu[name]), name
        assert float(state[i]["step"]) == 7.0


def test_converted_train_state_resumes_as_vct_resumes(tmp_path):
    """One epoch in vct (its train state saved), converted; then vct and the
    port each resume their own to epoch 2, dropout 0."""
    from vct_torch.data.synthetic import generate_dummy_data

    overrides = {**_overrides(rnn_type="lstm"), "train.learning_rate": "3e-3",
                 "train.resume": "true", "train.batch_size": "4"}
    x, y, _ = generate_dummy_data(num_samples=8, sequence_length=T_SEQ, height=HW, width=HW,
                                  num_classes=len(NAMES), seed=3)
    src, dst = str(tmp_path / "vct"), str(tmp_path / "port")
    cfg_v, _ = _configs(**overrides, **{"train.epochs": "1", "train.model_path": src})
    trainer_v = vct_engine.Trainer(cfg_v, NAMES)
    variables = _random_variables(trainer_v.model, x)
    _captured(trainer_v.fit, _vct_state(trainer_v, variables), x, y)
    assert convert.main([src, dst]) == 0

    cfg_v, _ = _configs(**overrides, **{"train.epochs": "2", "train.model_path": src})
    trainer_v = vct_engine.Trainer(cfg_v, NAMES)
    (state_v, run_v), out_v = _captured(trainer_v.fit, _vct_state(trainer_v, variables), x, y)
    _, cfg_t = _configs(**overrides, **{"train.epochs": "2", "train.model_path": dst})
    trainer = engine.Trainer(cfg_t, NAMES, device="cpu")
    (state, run), out = _captured(trainer.fit, trainer.init_state(), x, y)
    assert "Resuming training from epoch 1" in out_v and "Resuming training from epoch 1" in out
    assert "saved no dropout generator" in out
    assert state.step == int(state_v.step) == 4
    np.testing.assert_allclose(run.epoch_losses, run_v.epoch_losses, atol=TOL, rtol=0)
    params = jax.device_get(state_v.params)
    want = _in_port_layout(trainer.model, params, params, jax.device_get(state_v.extra_vars))
    got = {n: p.detach() for n, p in state.model.named_parameters()}
    _assert_within_largest(got, want)


def test_train_state_of_vcts_mesh_resumes_across_ranks_and_on_one_process(tmp_path):
    """vct trains one epoch on a (4, 2) mesh (a process of its own on a
    virtual 8-device CPU mesh, ``tests/vct_multirank_child.py``) and saves
    its train state; converted, it holds vct's parameters bit for bit and
    resumes to epoch 2 on a gloo world of (data 2, model 2) CPU ranks and on
    one process, SGD with a global-norm clip, dropout 0: the two agree
    within 1e-6 of each tensor's largest, the epoch losses within 1e-6."""
    import pickle
    import shutil
    import subprocess
    import sys
    from pathlib import Path

    import torch_multirank_child as child
    from vct_torch.data.synthetic import generate_dummy_data
    from vct_torch.tools.dryrun import run_world

    repo = Path(__file__).resolve().parents[1]
    overrides = {**child.DRYRUN, "train.batch_size": "4", "train.optimizer": "sgd",
                 "train.learning_rate": "0.05", "train.grad_clip": "1.0",
                 "train.resume": "true", "model.dropout": "0.0"}
    x, y, _ = generate_dummy_data(num_samples=8, sequence_length=4, height=32, width=32,
                                  num_classes=len(NAMES), seed=3)
    cfg_v = vct_engine.Config().replace(**overrides)
    variables = _random_variables(vct_engine.build_model(cfg_v.model, 4), x)
    with open(tmp_path / "vct_state.pkl", "wb") as f:
        pickle.dump({"overrides": overrides, "variables": variables, "x": x, "y": y,
                     "names": NAMES}, f)
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": str(repo),
           "XLA_FLAGS": "--xla_force_host_platform_device_count=8"}
    done = subprocess.run([sys.executable, str(repo / "tests" / "vct_multirank_child.py"),
                           str(tmp_path), "state"], env=env, cwd=str(repo),
                          capture_output=True, text=True, timeout=600)
    assert done.returncode == 0, (done.stdout + done.stderr)[-3000:]
    with open(tmp_path / "vct_saved.pkl", "rb") as f:
        saved_v = pickle.load(f)

    dst = tmp_path / "port"
    assert convert.main([str(tmp_path / "vct_state"), str(dst)]) == 0
    saved = torch.load(dst / "train_state.pt", weights_only=True)
    cfg_t = engine.Config().replace(**overrides, **{"train.model_path": str(dst),
                                                     "train.epochs": "2"})
    trainer = engine.Trainer(cfg_t, NAMES, device="cpu")
    stats = {k: v for k, v in variables.items() if k != "params"}
    params = saved_v["params"]
    for name, w in _in_port_layout(trainer.model, params, params, stats).items():
        assert torch.equal(saved["model"][name], w), name
    assert saved["step"] == saved_v["step"] == 2

    shutil.copytree(dst, tmp_path / "port_ranks")
    torch.save({"overrides": overrides, "x": x, "y": y}, tmp_path / "port_inputs.pt")
    run_world(4, ["tests/torch_multirank_child.py", "convert", str(tmp_path)])
    ranks = torch.load(tmp_path / "convert.pt", weights_only=False)
    assert ranks["sharded"] and ranks["step"] == 4
    (state, run), out = _captured(trainer.fit, trainer.init_state(), x, y)
    assert "Resuming training from epoch 1" in out
    assert run.epoch_losses[0] == ranks["epoch_losses"][0] == saved_v["epoch_losses"][0]
    np.testing.assert_allclose(ranks["epoch_losses"], run.epoch_losses, rtol=1e-6, atol=1e-6)
    for name, w in state.model.state_dict().items():
        err = float((ranks["params"][name] - w).abs().max())
        assert err <= 1e-6 * max(float(w.abs().max()), 1e-30), (name, err)


# ---------------------------------------------------------------------------
# caption checkpoints


@pytest.mark.parametrize("legacy", [False, True], ids=["tree", "legacy_tree"])
def test_caption_state_maps_moments_and_step(tmp_path, capsys, legacy):
    """vct's caption checkpoint with seeded moments and a count of 5; a
    legacy tree (params, extra_vars, opt_state only) takes its step from
    Adam's count."""
    cfg_v, cfg_t = common.configs("s2vt")
    vct_model, variables, _, _ = common.pair("s2vt")
    trainer_v = vct_caption.CaptionTrainer(cfg_v, common.vocab())
    state_v = common.vct_state(trainer_v, variables)
    state_v = state_v.replace(opt_state=_random_moments(state_v.opt_state, 5),
                              step=jnp.asarray(5, jnp.int32))
    src = str(tmp_path / "vct")
    history = {"epoch_losses": [2.5, 2.0], "val_losses": []}
    trainer_v.save_checkpoint(src, state_v, 2, 2.0, extra=history)
    if legacy:
        from vct.train.checkpoint import _atomic_tree_save

        _atomic_tree_save(os.path.join(src, "state"), {
            k: jax.device_get(getattr(state_v, k)) for k in ("params", "extra_vars",
                                                            "opt_state")})
    dst = str(tmp_path / "port")
    assert convert.main([src, dst]) == 0
    assert ("legacy caption checkpoint" in capsys.readouterr().out) == legacy
    manifest = json.loads((tmp_path / "port" / "manifest.json").read_text())
    assert manifest["framework"] == "vct_torch" and manifest["epoch"] == 2
    assert manifest["loss"] == 2.0 and manifest["epoch_losses"] == [2.5, 2.0]
    assert manifest["vocab"] == common.vocab().to_dict()
    saved = torch.load(tmp_path / "port" / "caption_state.pt", weights_only=True)
    assert saved["step"] == 5 and saved["generator"] is None

    trainer, state, cfg = restore_caption_trainer(dst, device="cpu")
    assert cfg == cfg_t and state.step == 5
    names = {id(p): n for n, p in trainer.model.named_parameters()}
    params = jax.device_get(state_v.params)
    stats = {k: v for k, v in variables.items() if k != "params"}
    adam = _adam(jax.device_get(state_v.opt_state))[0]
    mu = _in_port_layout(trainer.model, adam.mu, params, stats)
    nu = _in_port_layout(trainer.model, adam.nu, params, stats)
    for p in trainer._trained:
        moments = state.optimizer.state[p]
        assert torch.equal(moments["exp_avg"], mu[names[id(p)]]), names[id(p)]
        assert torch.equal(moments["exp_avg_sq"], nu[names[id(p)]]), names[id(p)]
        assert float(moments["step"]) == 5.0
    want = _in_port_layout(trainer.model, params, params, stats)
    for name, p in trainer.model.named_parameters():
        assert torch.equal(p.detach(), want[name]), name


def test_converted_caption_state_resumes_as_vct_resumes(tmp_path, capsys):
    lr = 1e-3
    cfg_v, cfg_t = common.configs("s2vt", learning_rate=lr, epochs=1)
    _, variables, _, _ = common.pair("s2vt")
    videos, captions = common.inputs(n=5)
    src, dst = str(tmp_path / "vct"), str(tmp_path / "port")
    trainer_v = vct_caption.CaptionTrainer(cfg_v, common.vocab())
    trainer_v.fit(common.vct_state(trainer_v, variables), videos, captions, batch_size=2,
                  checkpoint_dir=src, log=False)
    assert convert.main([src, dst]) == 0

    cfg_v, cfg_t = common.configs("s2vt", learning_rate=lr, epochs=2)
    trainer_v = vct_caption.CaptionTrainer(cfg_v, common.vocab())
    state_v, want_losses = trainer_v.fit(common.vct_state(trainer_v, variables), videos, captions,
                                         batch_size=2, checkpoint_dir=src, log=False)
    capsys.readouterr()
    trainer = CaptionTrainer(cfg_t, common.vocab(), device="cpu")
    state, losses = trainer.fit(trainer.init_state(), videos, captions, batch_size=2,
                                checkpoint_dir=dst, log=False)
    out = capsys.readouterr().out
    assert "Resuming from epoch 1" in out and "saved no dropout generator" in out
    assert state.step == int(state_v.step) == 6
    np.testing.assert_allclose(losses, want_losses, rtol=TOL)
    params = jax.device_get(state_v.params)
    stats = {k: v for k, v in variables.items() if k != "params"}
    want = _in_port_layout(trainer.model, params, params, stats)
    got = {n: p.detach() for n, p in state.model.named_parameters()}
    _assert_within_largest(got, want, lr_steps=lr * 3)


# ---------------------------------------------------------------------------
# refusals


def test_converter_refusals_write_nothing(tmp_path, capsys):
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(ValueError, match="holds no vct checkpoint"):
        convert.convert(str(empty), str(tmp_path / "a"))
    assert convert.main([str(empty), str(tmp_path / "a")]) == 1
    assert "holds no vct checkpoint" in capsys.readouterr().err
    assert not (tmp_path / "a").exists()

    cfg_v, _ = _configs(**FAMILIES["lrcn_lstm"])
    variables = _random_variables(vct_engine.build_model(cfg_v.model, T_SEQ), _sample())
    src = vct_checkpoint.save_checkpoint(str(tmp_path / "vct"), variables, cfg_v, NAMES)
    with pytest.raises(ValueError, match="another directory"):
        convert.convert(src, src)
    # A manifest whose config does not describe the saved tree: the bridge
    # refuses, and nothing is written.
    manifest = json.loads((tmp_path / "vct" / "manifest.json").read_text())
    manifest["config"]["model"]["hidden_size"] = 7
    (tmp_path / "vct" / "manifest.json").write_text(json.dumps(manifest))
    with pytest.raises(ValueError, match="shape"):
        convert.convert(src, str(tmp_path / "b"))
    assert not (tmp_path / "b").exists()
    manifest["config"]["model"]["hidden_size"] = 6
    (tmp_path / "vct" / "manifest.json").write_text(json.dumps(manifest))
    assert convert.main([src, str(tmp_path / "c")]) == 0
    with pytest.raises(ValueError, match="written by vct_torch"):
        convert.convert(str(tmp_path / "c"), str(tmp_path / "d"))
    assert convert.main([str(tmp_path / "c"), str(tmp_path / "d")]) == 1
    assert not (tmp_path / "d").exists()
