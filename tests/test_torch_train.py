"""vct_torch's training path against vct's, on the CPU.

The port runs its plain PyTorch versions on CPU tensors (autograd through
``stack_ref`` / ``selective_scan_ref``); vct runs its Pallas kernels in
interpret mode under their custom_vjps, as tests/test_pallas_ops.py does.
Weights are initialised in Flax, moved off their init values from a numpy
seed, and carried into the port by ``vct_torch.bridge.load_vct_variables``;
vct's gradients and parameters come back through the same bridge, so every
comparison is in the port's layout. Dropout is 0 (its streams cannot match
across frameworks), as tests/test_train_parity.py does.

Tolerances (f32, other summation orders): the loss atol = rtol = 1e-6 and
its logit gradient atol = 1e-7, rtol = 1e-5; per-parameter gradients of the
LRCN atol = rtol = 1e-5 (about 1.5e-5 of each gradient's largest magnitude
is f32 noise between the two frameworks' LayerNorms and sums); 5-step
trajectories losses rtol 1e-4 and parameters atol = rtol = 1e-5 (Adam's
elements at the gradients' noise floor excepted, see the test); epoch and
val losses of ``fit`` rtol 1e-4.
"""

import contextlib
import copy
import dataclasses
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vct.core import config as vct_config
from vct.core.metrics_contract import extract_metrics as vct_extract_metrics
from vct.data.batcher import train_test_split as vct_split
from vct.data.loaders import ArrayLoader as VctArrayLoader
from vct.data.synthetic import generate_dummy_data as vct_dummy_data
from vct.train import engine as vct_engine
from vct_torch.bridge import load_vct_variables
from vct_torch.core import config
from vct_torch.core.metrics_contract import extract_metrics
from vct_torch.data.batcher import train_test_split
from vct_torch.data.loaders import ArrayLoader, split_indices
from vct_torch.data.synthetic import generate_dummy_data
from vct_torch.models.layers import Dropout
from vct_torch.train import __main__ as cli
from vct_torch.train import engine
from vct_torch.train.checkpoint import load_checkpoint

CLASSES = 4
NAMES = [f"class_{i}" for i in range(CLASSES)]
T_SEQ, HW = 4, 32
GRAD_TOL = 1e-5


def _random_variables(vct_model, x, seed=0):
    """A numpy variables tree for ``vct_model`` from a seed, shaped by
    ``jax.eval_shape`` of its init (no Flax init runs): kernels N(0, 1/fan_in),
    scales and norms' weights near 1, BatchNorm variances in [1, 1.5), other
    leaves N(0, 0.01)."""
    shapes = jax.eval_shape(vct_model.init, jax.random.PRNGKey(0), jnp.asarray(x[:1]))
    rng = np.random.RandomState(seed)

    def make(path, leaf):
        name, shape = getattr(path[-1], "key", ""), leaf.shape
        if name == "var":
            v = 1.0 + 0.5 * rng.rand(*shape)
        elif name == "scale" or (name == "weight" and len(shape) == 1):
            v = 1.0 + 0.1 * rng.randn(*shape)
        elif len(shape) >= 2:
            v = rng.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
        else:
            v = 0.1 * rng.randn(*shape)
        return np.asarray(v, np.float32)

    return jax.tree_util.tree_map_with_path(make, shapes)


def _vct_state(trainer, variables):
    """vct's TrainState over ``variables`` without a Flax init."""
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    extra = {k: jax.tree_util.tree_map(jnp.asarray, v) for k, v in variables.items()
             if k != "params"}
    return vct_engine.host_to_device(vct_engine.TrainState(
        step=jnp.zeros((), jnp.int32), params=params, extra_vars=extra,
        opt_state=trainer._tx.init(params), rng=jax.random.PRNGKey(0)), trainer.mesh)


def _overrides(**model):
    kw = {"model.cnn_backbone": "resnet18", "model.rnn_input_size": "8",
          "model.hidden_size": "6", "model.rnn_layer": "2", "model.scan_impl": "pallas",
          "model.dropout": "0.0", "data.sequence_length": str(T_SEQ),
          "data.img_height": str(HW), "data.img_width": str(HW), "train.batch_size": "8"}
    kw.update({f"model.{k}": str(v) for k, v in model.items()})
    return kw


def _configs(**overrides):
    return (vct_config.Config().replace(**overrides), config.Config().replace(**overrides))


def _in_port_layout(model, tree, stats):
    """A copy of ``model`` holding vct's ``tree`` (params-shaped) in the
    port's layout."""
    clone = copy.deepcopy(model)
    load_vct_variables(clone, {"params": tree, **stats})
    return {n: p.detach() for n, p in clone.named_parameters()}


def _assert_grad_close(got, want, label):
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=GRAD_TOL, rtol=GRAD_TOL,
                               err_msg=label)


# ---------------------------------------------------------------------------
# config, data


@pytest.mark.parametrize("overrides", [
    {},
    {"model.rnn_type": "lstm", "model.hidden_size": "56", "train.epochs": "3"},
    {"train.learning_rate": "3e-4", "train.optimizer": "adamw", "train.grad_clip": "1.0",
     "data.synthetic": "true", "model.bidirectional": "yes", "mesh.donate": "0"},
    {"model.freeze_until": "conv1,bn1,layer1", "model.finetune": "on",
     "train.lr_plateau_factor": "0.1", "serve.backend_port": "6000"},
])
def test_config_overrides_match_vct(overrides):
    theirs, ours = _configs(**overrides)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert ours.artifact_name() == theirs.artifact_name()
    argv = [a for i, (k, v) in enumerate(overrides.items())
            for a in ([f"--{k}={v}"] if i % 2 else [f"--{k}", v])]
    assert config.parse_cli_overrides(argv) == vct_config.parse_cli_overrides(argv)
    assert config.Config.from_dict(ours.to_dict()) == ours


def test_config_files_and_errors_match_vct(tmp_path):
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps({"model": {"rnn_type": "gru"}, "train": {"epochs": 2}}))
    got = config.load_config(str(path), {"train.seed": "7"})
    want = vct_config.load_config(str(path), {"train.seed": "7"})
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    for mod in (config, vct_config):
        with pytest.raises(KeyError, match="rnn_typ"):
            mod.Config().replace(**{"model.rnn_typ": "lstm"})
        with pytest.raises(KeyError, match="dotted"):
            mod.Config().replace(epochs=3)
        with pytest.raises(ValueError, match="Missing value"):
            mod.parse_cli_overrides(["--train.epochs"])


@pytest.mark.parametrize("mode", ["multiclass", "multiple_binary"])
def test_synthetic_data_split_and_loader_order_match_vct(mode):
    kw = dict(num_samples=11, sequence_length=3, height=5, width=4, num_classes=CLASSES,
              classif_mode=mode, seed=3)
    ours, theirs = generate_dummy_data(**kw), vct_dummy_data(**kw)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    x, y, _ = ours
    for a, b in zip(train_test_split(x, y, 0.3, 5), vct_split(x, y, 0.3, 5)):
        np.testing.assert_array_equal(a, b)
    from vct.data.loaders import split_indices as vct_split_indices

    for a, b in zip(split_indices(11, 0.3, 5), vct_split_indices(11, 0.3, 5)):
        np.testing.assert_array_equal(a, b)
    rng_a, rng_b = np.random.RandomState(9), np.random.RandomState(9)
    for _ in range(2):  # two epochs: one permutation each
        for (xa, ya, ma), (xb, yb, mb) in zip(ArrayLoader(x, y, 4).epoch(rng_a),
                                             VctArrayLoader(x, y, 4).epoch(rng_b)):
            np.testing.assert_array_equal(xa, xb)
            np.testing.assert_array_equal(ya, yb)
            np.testing.assert_array_equal(ma, mb)


@pytest.mark.parametrize("mode", ["multiclass", "multiple_binary"])
def test_class_weights_match_vct(mode):
    _, y, _ = generate_dummy_data(num_samples=13, sequence_length=1, height=1, width=1,
                                  num_classes=CLASSES, classif_mode=mode, seed=1)
    np.testing.assert_array_equal(engine.compute_class_weights(y, CLASSES, mode),
                                  vct_engine.compute_class_weights(y, CLASSES, mode))


# ---------------------------------------------------------------------------
# the loss


def _vct_loss_shim(mode, weights):
    shim = vct_engine.Trainer.__new__(vct_engine.Trainer)
    shim.classif_mode, shim.num_classes = mode, CLASSES
    shim.class_weights = None if weights is None else jnp.asarray(weights)
    return shim


def _port_loss_shim(mode, weights):
    shim = engine.Trainer.__new__(engine.Trainer)
    shim.classif_mode, shim.num_classes = mode, CLASSES
    shim.class_weights = None if weights is None else torch.from_numpy(weights)
    return shim


@pytest.mark.parametrize("weighted", [False, True], ids=["plain", "weighted"])
@pytest.mark.parametrize("mode", ["multiclass", "multiple_binary"])
def test_loss_and_logit_gradient_match_vct(mode, weighted):
    rng = np.random.RandomState(4)
    logits = (rng.randn(6, CLASSES) * 2).astype(np.float32)
    if mode == "multiclass":
        labels = rng.randint(0, CLASSES, 6).astype(np.int64)
    else:
        labels = (rng.rand(6, CLASSES) > 0.5).astype(np.float32)
    mask = np.array([1, 1, 0, 1, 1, 0], np.float32)  # padded rows count for nothing
    weights = engine.compute_class_weights(labels[mask > 0], CLASSES, mode) if weighted else None

    vct_shim = _vct_loss_shim(mode, weights)

    def vct_loss(lg):
        return vct_shim._loss_fn(lg, jnp.asarray(labels), jnp.asarray(mask))

    (want, (w_correct, w_total)), want_grad = jax.value_and_grad(vct_loss, has_aux=True)(
        jnp.asarray(logits))
    lg = torch.from_numpy(logits).requires_grad_(True)
    got, (correct, total) = _port_loss_shim(mode, weights)._loss_fn(
        lg, torch.from_numpy(labels), torch.from_numpy(mask))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), atol=1e-6, rtol=1e-6)
    assert (correct.item(), total.item()) == (float(w_correct), float(w_total))
    np.testing.assert_allclose(lg.grad.numpy(), np.asarray(want_grad), atol=1e-7, rtol=1e-5)
    assert not lg.grad[mask == 0].any()


# ---------------------------------------------------------------------------
# per-parameter gradients of the LRCN


def _lrcn_pair(**model):
    cfg_v, cfg_t = _configs(**_overrides(**model))
    vct_model = vct_engine.build_model(cfg_v.model, T_SEQ)
    trainer = engine.Trainer(cfg_t, NAMES, device="cpu")
    return vct_model, trainer


@pytest.mark.parametrize("bidirectional", [False, True], ids=["uni", "bidir"])
@pytest.mark.parametrize("rnn_type", ["lstm", "gru", "mamba"])
def test_lrcn_parameter_gradients_match_vct(rnn_type, bidirectional):
    """Every trained parameter's gradient within atol = rtol = 1e-5, from
    the same backbone features (the frozen backbone is stop_gradient in vct
    and records no graph here, so the features are all the head sees of
    it); the backbone's parameters get none."""
    vct_model, trainer = _lrcn_pair(rnn_type=rnn_type, bidirectional=bidirectional)
    rng = np.random.RandomState(0)
    feats = np.abs(rng.randn(2, T_SEQ, 512)).astype(np.float32)  # post-ReLU pooled features
    y = np.array([1, 3], np.int64)
    mask = np.ones(2, np.float32)
    variables = _random_variables(vct_model, np.zeros((1, T_SEQ, HW, HW, 3), np.float32))
    stats = {k: v for k, v in variables.items() if k != "params"}
    shim = _vct_loss_shim("multiclass", None)

    def loss_of(params):
        logits = vct_model.apply({"params": params, **stats}, jnp.asarray(feats),
                                 deterministic=False, from_features=True,
                                 rngs={"dropout": jax.random.PRNGKey(1)})
        return shim._loss_fn(logits, jnp.asarray(y), jnp.asarray(mask))[0]

    want_loss, grads = jax.jit(jax.value_and_grad(loss_of))(variables["params"])
    model = trainer.model
    load_vct_variables(model, variables)
    state = trainer.init_state()
    model.train()
    loss, _ = trainer._loss_fn(model(torch.from_numpy(feats), from_features=True),
                               torch.from_numpy(y), torch.from_numpy(mask))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), atol=1e-6, rtol=1e-6)
    want = _in_port_layout(model, jax.tree_util.tree_map(np.asarray, grads), stats)
    for name, p in model.named_parameters():
        if name.startswith("cnn_backbone."):  # frozen: no gradient
            assert p.grad is None and not p.requires_grad, name
        elif name.endswith(".mixer.D"):  # declared, never read
            assert p.grad is None and not want[name].any(), name
        else:
            assert p.grad is not None, name
            _assert_grad_close(p.grad, want[name], name)
    assert state.step == 0


def test_lrcn_in_train_mode_keeps_the_backbone_at_running_statistics():
    """From raw clips under ``train()`` (dropout 0): the backbone's
    BatchNorm stays in eval mode, its features carry no graph, and the
    logits match vct's within atol = rtol = 1e-4 (tests/test_torch_recurrent.py's
    tolerance for LRCN logits)."""
    vct_model, trainer = _lrcn_pair(rnn_type="mamba")
    x = np.random.RandomState(1).rand(2, T_SEQ, HW, HW, 3).astype(np.float32)
    variables = _random_variables(vct_model, x)
    want = jax.jit(vct_model.apply)(variables, jnp.asarray(x))
    model = trainer.model
    load_vct_variables(model, variables)
    model.train()
    assert not any(m.training for m in model.cnn_backbone.modules()
                   if isinstance(m, torch.nn.BatchNorm2d))
    feats = model(torch.from_numpy(x), features_only=True)
    assert feats.grad_fn is None and not feats.requires_grad
    got = model(torch.from_numpy(x))
    assert got.requires_grad
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------------------
# 5-step trajectories in feature mode


@pytest.mark.parametrize("opt,rnn_type,extra", [
    ("adam", "lstm", {"train.learning_rate": "1e-3"}),
    ("adamw", "mamba", {"train.learning_rate": "1e-3", "train.weight_decay": "0.05",
                        "train.grad_clip": "0.05"}),
    ("sgd", "gru", {"train.learning_rate": "0.05", "train.weighted_loss": "true"}),
    ("adam", "mamba", {"train.learning_rate": "1e-3", "train.grad_clip": "1.0",
                       "model.model_family": "videomamba", "model.vm_n_layer": "2",
                       "model.vm_d_model": "32", "model.vm_d_inner": "64"}),
])
def test_five_step_trajectories_match_vct(opt, rnn_type, extra):
    """Five steps of vct's compiled train step against the port's, in
    feature mode (the LRCN's heads, and VideoMamba's at a small width with
    the reference's clip of 1.0): each step's loss within rtol 1e-4, and every parameter
    after the five within atol = rtol = 1e-5, except, under adam and
    adamw, the elements whose gradient at some step lay below 1e-5 of its
    tensor's largest (the f32 noise floor of the gradients, where Adam's
    normalised step is a coin's sign): those within the most two Adam
    trajectories can part by, 2 lr a step."""
    overrides = {**_overrides(rnn_type=rnn_type), "train.optimizer": opt,
                 "train.feature_cache": "true", **extra}
    cfg_v, cfg_t = _configs(**overrides)
    rng = np.random.RandomState(2)
    weights = np.array([0.5, 1.0, 2.0, 1.5], np.float32)
    vct_trainer = vct_engine.Trainer(cfg_v, NAMES, class_weights=weights)
    variables = _random_variables(vct_trainer.model,
                                  np.zeros((1, T_SEQ, HW, HW, 3), np.float32))
    state_v = _vct_state(vct_trainer, variables)
    vct_trainer._feature_mode = True
    step_v = vct_trainer._build_train_step()
    trainer = engine.Trainer(cfg_t, NAMES, class_weights=weights, device="cpu")
    load_vct_variables(trainer.model, variables)
    trainer._feature_mode = True
    state_t = trainer.init_state()
    shard = vct_engine.batch_sharding(vct_trainer.mesh)
    noisy = {n: torch.zeros_like(p, dtype=torch.bool) for n, p in trainer.model.named_parameters()}
    for step in range(5):
        xb = rng.randn(8, T_SEQ, 512).astype(np.float32)
        yb = rng.randint(0, CLASSES, 8).astype(np.int64)
        mask = np.ones(8, np.float32)
        mask[-1] = 0.0
        state_v, want, _, _ = step_v(state_v, *vct_trainer._put_batch(xb, yb, mask, shard))
        got, _, _ = trainer._train_step(state_t, *trainer._put_batch(xb, yb, mask))
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-4, err_msg=f"step {step}")
        for n, p in trainer.model.named_parameters():
            if p.grad is not None:
                noisy[n] |= p.grad.abs() < GRAD_TOL * p.grad.abs().max()
    stats = {k: v for k, v in variables.items() if k != "params"}
    want_params = _in_port_layout(trainer.model, jax.tree_util.tree_map(np.asarray,
                                                                        state_v.params), stats)
    lr = cfg_t.train.learning_rate
    for name, p in trainer.model.named_parameters():
        got, want = p.detach(), want_params[name]
        close = (got - want).abs() <= GRAD_TOL + GRAD_TOL * want.abs()
        if opt == "sgd":
            assert close.all(), name
        else:
            assert (close | noisy[name]).all(), name
            assert ((got - want).abs() <= 2 * lr * 5).all(), name
            assert noisy[name].float().mean() < 0.01, name
    assert state_t.step == 5


def test_clipping_sees_the_trained_parameters_only():
    """The global norm is taken over the trained partition: a frozen
    parameter's gradient, even if one were there, neither counts nor scales."""
    cfg = config.Config().replace(**_overrides(rnn_type="gru"), **{"train.grad_clip": "1.0"})
    trainer = engine.Trainer(cfg, NAMES, device="cpu")
    trained = trainer._trained
    frozen = next(p for p in trainer.model.parameters() if not p.requires_grad)
    frozen.grad = torch.full_like(frozen, 100.0)
    for p in trained:
        p.grad = torch.full_like(p, 1.0)
    n = sum(p.numel() for p in trained)
    trainer._clip_gradients()
    assert torch.equal(frozen.grad, torch.full_like(frozen, 100.0))
    np.testing.assert_allclose(trained[0].grad[0, 0].item(), 1.0 / np.sqrt(n), rtol=1e-5)


# ---------------------------------------------------------------------------
# freezing


def test_freeze_until_matches_vct():
    overrides = {**_overrides(rnn_type="gru"), "model.finetune": "true",
                 "model.freeze_until": "conv1,bn1,layer1", "train.optimizer": "sgd",
                 "train.learning_rate": "0.1"}
    cfg_v, cfg_t = _configs(**overrides)
    vct_model = vct_engine.build_model(cfg_v.model, T_SEQ)
    x = np.random.RandomState(0).rand(2, T_SEQ, HW, HW, 3).astype(np.float32)
    params = _random_variables(vct_model, x)["params"]
    labels = vct_engine._param_label_tree(params, True, "conv1,bn1,layer1")
    trainer = engine.Trainer(cfg_t, NAMES, device="cpu")
    model = trainer.model
    for name, p in model.named_parameters():
        top, _, rest = name.partition(".")
        label = labels[top] if top != "cnn_backbone" else labels[top][rest.split(".")[0]]
        assert p.requires_grad == (label == "train"), name
    assert engine.count_parameters(model, True, "conv1,bn1,layer1") == \
        vct_engine.count_parameters(params, True, "conv1,bn1,layer1")
    assert engine.count_parameters(model) == vct_engine.count_parameters(params)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    state = trainer.init_state()
    trainer._train_step(state, *trainer._put_batch(x, np.array([0, 2]), np.ones(2, np.float32)))
    for name, p in model.named_parameters():
        moved = not torch.equal(p, before[name])
        frozen = name.split(".")[1].startswith(("conv1", "bn1", "layer1")) \
            if name.startswith("cnn_backbone.") else False
        assert moved != frozen, name
        assert (p.grad is None) == frozen, name


def test_dropout_draws_from_the_trainers_generator():
    cfg = config.Config().replace(**_overrides(rnn_type="lstm", dropout=0.5))
    masks = []
    for _ in range(2):
        trainer = engine.Trainer(cfg, NAMES, device="cpu")
        trainer.init_state()
        drops = [m for m in trainer.model.modules() if isinstance(m, Dropout)]
        assert drops and all(m.generator is drops[0].generator for m in drops)
        torch.manual_seed(123 + len(masks))  # the default generator is not what draws
        masks.append(drops[0].train()(torch.ones(64)))
    assert torch.equal(masks[0], masks[1])
    assert set(masks[0].unique().tolist()) == {0.0, 2.0}


@pytest.mark.parametrize("field,value", [("mesh.model_axis", "2")])
def test_unported_options_raise_and_name_the_roadmap(field, value):
    """A model axis of 2 over one process's one device: vct's make_mesh
    refuses it with the same ValueError (nothing of it is unported now)."""
    from vct.parallel.mesh import make_mesh as vct_make_mesh

    cfg = config.Config().replace(**_overrides(rnn_type="gru"), **{field: value})
    with pytest.raises(ValueError) as want:
        vct_make_mesh(jax.devices()[:1], model=int(value))
    with pytest.raises(ValueError, match="not divisible by model=2") as got:
        engine.Trainer(cfg, NAMES, device="cpu")
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# fit and evaluate


def _captured(fn, *args, **kwargs):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = fn(*args, **kwargs)
    return result, out.getvalue()


def test_fit_stop_epoch_lr_decay_and_metric_block_match_vct():
    overrides = {**_overrides(rnn_type="gru"), "train.feature_cache": "true",
                 "train.epochs": "6", "train.learning_rate": "0.3", "train.optimizer": "sgd",
                 "train.early_stop_patience": "2", "train.lr_plateau_factor": "0.5",
                 "train.lr_plateau_patience": "1"}
    cfg_v, cfg_t = _configs(**overrides)
    x, y, _ = generate_dummy_data(num_samples=14, sequence_length=T_SEQ, height=HW, width=HW,
                                  num_classes=CLASSES, seed=5)
    xt, xv, yt, yv = train_test_split(x, y, 0.3, 42)
    vct_trainer = vct_engine.Trainer(cfg_v, NAMES)
    variables = _random_variables(vct_trainer.model, xt)
    (state_v, run_v), out_v = _captured(vct_trainer.fit, _vct_state(vct_trainer, variables), xt,
                                        yt, val=(xv, yv))
    trainer = engine.Trainer(cfg_t, NAMES, device="cpu")
    load_vct_variables(trainer.model, variables)
    (state_t, run_t), out_t = _captured(trainer.fit, trainer.init_state(), xt, yt, val=(xv, yv))
    assert len(run_t.epoch_losses) == len(run_v.epoch_losses)
    np.testing.assert_allclose(run_t.epoch_losses, run_v.epoch_losses, rtol=1e-4)
    np.testing.assert_allclose(run_t.val_losses, run_v.val_losses, rtol=1e-4)
    assert run_t.epoch_accs == run_v.epoch_accs

    def decays(out):
        return [l for l in out.splitlines() if l.startswith("Reducing learning rate")]

    assert decays(out_t) == decays(out_v) and decays(out_t)
    if len(run_t.epoch_losses) < 6:
        assert "Epoch 6/6" not in out_t
    assert (run_t.trainable_params, run_t.non_trainable_params) == \
        (run_v.trainable_params, run_v.non_trainable_params)
    m_v, block_v = _captured(vct_trainer.evaluate, state_v, xv, yv, run=run_v)
    m_t, block_t = _captured(trainer.evaluate, state_t, xv, yv, run=run_t)
    got, want = extract_metrics(block_t + out_t), vct_extract_metrics(block_v + out_v)
    assert dataclasses.asdict(extract_metrics(block_v + out_v)) == dataclasses.asdict(want)
    for key in ("accuracy", "precision", "recall", "f1", "trainable_params"):
        assert getattr(got, key) == getattr(want, key), key
    assert [l for l in block_t.splitlines() if not l.startswith("inference_duration")] == \
        [l for l in block_v.splitlines() if not l.startswith("inference_duration")]


def test_multilabel_evaluate_matches_vct():
    overrides = {**_overrides(rnn_type="lstm"), "model.classif_mode": "multiple_binary"}
    cfg_v, cfg_t = _configs(**overrides)
    x, y, _ = generate_dummy_data(num_samples=10, sequence_length=T_SEQ, height=HW, width=HW,
                                  num_classes=CLASSES, classif_mode="multiple_binary", seed=2)
    vct_trainer = vct_engine.Trainer(cfg_v, NAMES)
    variables = _random_variables(vct_trainer.model, x)
    state_v = _vct_state(vct_trainer, variables)
    trainer = engine.Trainer(cfg_t, NAMES, device="cpu")
    load_vct_variables(trainer.model, variables)
    m_v, block_v = _captured(vct_trainer.evaluate, state_v, x, y)
    m_t, block_t = _captured(trainer.evaluate, trainer.init_state(), x, y)
    assert m_t.per_class == m_v.per_class
    assert (m_t.accuracy, m_t.f1) == (m_v.accuracy, m_v.f1)
    assert block_t.splitlines()[:-1] == block_v.splitlines()[:-1]


def test_cli_trains_saves_and_prints_the_block_on_the_cpu(tmp_path):
    argv = ["--device", "cpu", "--data.synthetic", "true", "--data.synthetic_samples", "10",
            *[a for k, v in _overrides(rnn_type="mamba").items() for a in (f"--{k}", v)],
            "--train.epochs", "2", "--train.batch_size", "4", "--train.weighted_loss", "true",
            "--train.model_path", str(tmp_path / "ck")]
    rc, out = _captured(cli.main, argv)
    assert rc == 0
    lines = out.splitlines()
    assert lines[0] == "Train: (8, 4, 32, 32, 3), Test: (2, 4, 32, 32, 3), classes: " + str(NAMES)
    assert sum(l.startswith("Epoch ") for l in lines) == 2
    metrics = extract_metrics(out)
    assert 0.0 <= metrics.accuracy <= 1.0 and metrics.trainable_params > 0
    state_dict, cfg, names, manifest = load_checkpoint(str(tmp_path / "ck"))
    assert manifest["framework"] == "vct_torch" and names == NAMES
    assert cfg.model.rnn_type == "mamba" and cfg.train.epochs == 2
    assert "mamba_0.mixer.A_log" in state_dict


def test_cli_refuses_real_datasets_and_needs_the_card_by_default(monkeypatch, tmp_path):
    """A dataset directory that does not exist is refused as vct refuses it
    (the ingest itself is held against vct in test_torch_stream.py)."""
    from vct.train import __main__ as vct_cli

    argv = ["--data.dataset_path", str(tmp_path / "none"),
            "--data.processed_data_path", str(tmp_path / "cache")]
    with pytest.raises(FileNotFoundError) as want:
        vct_cli.main(argv)
    with pytest.raises(FileNotFoundError) as got:
        cli.main(["--device", "cpu", *argv])
    assert str(got.value) == str(want.value)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["--data.synthetic", "true", *[a for k, v in _overrides().items()
                                                for a in (f"--{k}", v)]])
