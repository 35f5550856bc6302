"""vct_torch's finetune path, backbone rematerialisation and stem fold
against vct's, on the CPU.

The backbone trains here (``model.finetune``), so gradients run through
resnet18's conv stack: every conv kernel, BatchNorm scale and bias and
downsample conv. Weights are drawn in Flax's layout from a numpy seed, with
BatchNorm's running statistics drawn as vct's
tests/test_full_model_parity.py draws them (so eval-mode BatchNorm is no
identity), and carried into the port by ``vct_torch.bridge``; vct's
gradients and parameters come back through the same bridge. Dropout is 0,
and the heads run ``scan_impl="scan"`` (the kernels' own gradients are held
in tests/test_torch_recurrent.py and tests/test_torch_kernels.py; here the
conv stack is the subject, and vct's interpreted Pallas would double the
file's time).

Tolerances (f32, other summation orders through the conv backward): each
parameter's gradient within 3e-5 of its tensor's largest magnitude, the
loss within 2e-5 (vct's tests/test_finetune_parity.py). 3e-5 is the f32
noise of a gradient through the whole conv stack: against vct's gradients
computed in float64 on the same weights, vct's own f32 gradients lie up to
2.3e-5 of a tensor's largest away and the port's up to 1.8e-5; the port and
vct lie up to 1.7e-5 apart (resnet18, 32x32, T=4, B=2, on a CPU;
``python tests/torch_finetune_noise.py``). 3 Adam steps by
tests/test_torch_train.py's 5-step rule (losses rtol 1e-4, parameters atol
= rtol = 1e-5 outside the gradients' noise floor), the frozen parameters
bit-unchanged; the fold within 1e-4 at f32 (vct's
tests/test_weight_port.py), and bit-equal to vct's folded weights.
``model.remat_backbone`` on and off: gradients bit-equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_train import (
    GRAD_TOL,
    HW,
    NAMES,
    T_SEQ,
    _configs,
    _in_port_layout,
    _overrides,
    _random_variables,
    _vct_loss_shim,
    _vct_state,
)
from vct.models.backbones import BACKBONES as VCT_BACKBONES
from vct.models.backbones import port as vct_port
from vct.train import engine as vct_engine
from vct_torch.bridge import load_vct_variables
from vct_torch.core import config
from vct_torch.models import init_weights
from vct_torch.models.backbones import build_backbone
from vct_torch.models.backbones import port
from vct_torch.models.lrcn import backbone_features
from vct_torch.train import engine

BATCH = 2
GRAD_RTOL = 3e-5  # of each gradient tensor's largest magnitude: the f32 noise floor
LOSS_ATOL = 2e-5
FREEZE = "conv1,bn1,layer1,layer2,layer3"
FOLD_SIZES = {"inception_v3": 96}  # vct's: 64 for every other family


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this file's CPU convolutions: the tier-1 lane
    runs six test processes on the host's cores, and torch's thread pools,
    each as wide as the host, then oversubscribe them and spin (six copies of
    this file at once ran about ten times slower with the default threads
    than with one each)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _randomize_bn_stats(variables, seed=7):
    """BatchNorm's running statistics as vct's
    ``test_full_model_parity._randomize_bn_stats`` draws them: means
    N(0, 0.1^2), variances |N(0, 1)| + 0.5."""
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        name = getattr(path[-1], "key", "")
        if name == "mean":
            return (rng.randn(*leaf.shape) * 0.1).astype(np.float32)
        if name == "var":
            return (np.abs(rng.randn(*leaf.shape)) + 0.5).astype(np.float32)
        return leaf

    stats = jax.tree_util.tree_map_with_path(draw, variables["batch_stats"])
    return {**variables, "batch_stats": stats}


def _finetune_pair(**model):
    """(vct's model, the port's Trainer, bridged-ready variables, clips)."""
    cfg_v, cfg_t = _configs(**{**_overrides(**{"finetune": "true", "scan_impl": "scan", **model}),
                               "train.batch_size": str(BATCH)})
    vct_model = vct_engine.build_model(cfg_v.model, T_SEQ)
    x = np.random.RandomState(1).rand(BATCH, T_SEQ, HW, HW, 3).astype(np.float32)
    variables = _randomize_bn_stats(_random_variables(vct_model, x))
    trainer = engine.Trainer(cfg_t, NAMES, device="cpu")
    load_vct_variables(trainer.model, variables)
    return vct_model, trainer, variables, x


def _port_gradients(trainer, x, y):
    model = trainer.model
    trainer.init_state()
    model.train()
    model.zero_grad(set_to_none=True)
    loss, _ = trainer._loss_fn(model(torch.from_numpy(x)), torch.from_numpy(y),
                               torch.ones(len(y)))
    loss.backward()
    return loss.item(), {n: p.grad for n, p in model.named_parameters()}


@pytest.mark.parametrize("model", [
    {"rnn_type": "lstm"},
    {"rnn_type": "mamba", "remat_backbone": "true"},
    {"model_family": "videomamba", "vm_d_model": "16", "vm_d_inner": "32", "vm_n_layer": "1"},
], ids=["lrcn_lstm", "lrcn_mamba_remat", "videomamba"])
def test_finetune_gradients_match_vct_through_the_conv_stack(model):
    """Every parameter's gradient, the backbone's included, within 3e-5 of
    its tensor's largest magnitude of ``jax.value_and_grad`` of vct's loss
    through the same model; the loss within 2e-5; the backbone's largest
    gradient above 0 (the conv backward is in the graph). The Mamba head
    runs with ``remat_backbone`` on both sides; without it the port's
    gradients are bit-equal
    (``test_remat_backbone_recomputes_only_a_backbone_that_trains``), so one
    case holds both."""
    vct_model, trainer, variables, x = _finetune_pair(**model)
    if "rnn_type" in model:  # build_lrcn reads model.remat_backbone
        assert trainer.model.remat_backbone == ("remat_backbone" in model)
    y = np.array([1, 3], np.int64)
    stats = {k: v for k, v in variables.items() if k != "params"}
    shim = _vct_loss_shim("multiclass", None)

    def loss_of(params):
        logits = vct_model.apply({"params": params, **stats}, jnp.asarray(x))
        return shim._loss_fn(logits, jnp.asarray(y), jnp.ones((BATCH,), jnp.float32))[0]

    want_loss, grads = jax.jit(jax.value_and_grad(loss_of))(variables["params"])
    loss, got = _port_gradients(trainer, x, y)
    np.testing.assert_allclose(loss, float(want_loss), atol=LOSS_ATOL, rtol=0)
    want = _in_port_layout(trainer.model, jax.tree_util.tree_map(np.asarray, grads), stats)
    backbone_max = 0.0
    for name, g in got.items():
        if name.endswith(".mixer.D"):  # declared, never read
            assert g is None and not want[name].any(), name
            continue
        assert g is not None, name
        scale = want[name].abs().max().item()
        err = (g - want[name]).abs().max().item()
        assert err <= GRAD_RTOL * scale, f"{name}: {err} against {GRAD_RTOL} x {scale}"
        if name.startswith("cnn_backbone."):
            backbone_max = max(backbone_max, g.abs().max().item())
    assert backbone_max > 0.0


def test_finetune_adam_with_freeze_until_matches_vct():
    """3 Adam steps of the port's Trainer against vct's compiled step with
    conv1..layer3 frozen, by tests/test_torch_train.py's 5-step rule: each
    loss within rtol 1e-4 and every trained parameter within atol = rtol =
    1e-5, except elements whose gradient lay below 1e-5 of its tensor's
    largest, and not at exactly 0, at some step (Adam's step there follows
    the noise's sign): those within 2 lr a step. The share under 1% is taken
    over the elements that are beyond 1e-5, not over all at the floor: at
    this size 1.4% of ``adapt.adapt1.weight`` lies at the floor, and none of
    it is beyond 1e-5. An exact 0 (a layer4 tap that meets only padding: at
    32x32 layer4 sees a 1x1 map) is no noise; Adam leaves it on both sides.
    Every frozen parameter bit-unchanged on both sides, and layer4 moved."""
    steps, lr = 3, 1e-3
    cfg_v, cfg_t = _configs(**{
        **_overrides(rnn_type="lstm", finetune="true", freeze_until=FREEZE, scan_impl="scan"),
        "train.batch_size": str(BATCH), "train.optimizer": "adam", "train.learning_rate": str(lr)})
    vct_trainer = vct_engine.Trainer(cfg_v, NAMES)
    rng = np.random.RandomState(2)
    x0 = np.zeros((1, T_SEQ, HW, HW, 3), np.float32)
    variables = _randomize_bn_stats(_random_variables(vct_trainer.model, x0))
    state_v = _vct_state(vct_trainer, variables)
    step_v = vct_trainer._build_train_step()
    trainer = engine.Trainer(cfg_t, NAMES, device="cpu")
    load_vct_variables(trainer.model, variables)
    state_t = trainer.init_state()
    before = {n: p.detach().clone() for n, p in trainer.model.named_parameters()}
    shard = vct_engine.batch_sharding(vct_trainer.mesh)
    noisy = {n: torch.zeros_like(p, dtype=torch.bool) for n, p in before.items()}
    for step in range(steps):
        xb = rng.rand(BATCH, T_SEQ, HW, HW, 3).astype(np.float32)
        yb = rng.randint(0, len(NAMES), BATCH).astype(np.int64)
        mask = np.ones(BATCH, np.float32)
        state_v, want, _, _ = step_v(state_v, *vct_trainer._put_batch(xb, yb, mask, shard))
        got, _, _ = trainer._train_step(state_t, *trainer._put_batch(xb, yb, mask))
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-4, err_msg=f"step {step}")
        for n, p in trainer.model.named_parameters():
            if p.grad is not None:
                noisy[n] |= (p.grad != 0) & (p.grad.abs() < GRAD_TOL * p.grad.abs().max())
    stats = {k: v for k, v in variables.items() if k != "params"}
    want_params = _in_port_layout(trainer.model, jax.tree_util.tree_map(np.asarray,
                                                                        state_v.params), stats)
    frozen = []
    for name, p in trainer.model.named_parameters():
        got, want = p.detach(), want_params[name]
        if p.requires_grad:
            close = (got - want).abs() <= GRAD_TOL + GRAD_TOL * want.abs()
            assert (close | noisy[name]).all(), name
            assert ((got - want).abs() <= 2 * lr * steps).all(), name
            assert (~close).float().mean() < 0.01, name
        else:
            frozen.append(name)
            assert torch.equal(got, before[name]) and torch.equal(want, before[name]), name
    assert {n.split(".")[1].split("_")[0] for n in frozen} == set(FREEZE.split(","))
    assert not torch.equal(trainer.model.cnn_backbone.layer4_1.conv2.weight,
                           before["cnn_backbone.layer4_1.conv2.weight"])
    assert state_t.step == steps


@pytest.mark.parametrize("finetune,grad", [(True, True), (True, False), (False, True)],
                         ids=["finetune", "no_grad", "frozen"])
def test_remat_backbone_recomputes_only_a_backbone_that_trains(finetune, grad):
    """``model.remat_backbone`` on and off give bit-equal gradients and
    logits. The backbone's forward pre-hook counts 2 calls a step with it (the
    checkpoint's recompute in the backward) and 1 without; under
    ``no_grad`` (eval, export) and with a frozen backbone it never engages:
    1 call either way."""
    cfg = config.Config().replace(**_overrides(rnn_type="mamba", finetune=str(finetune).lower()))
    trainer = engine.Trainer(cfg, NAMES, device="cpu")  # seeded weights
    x = np.random.RandomState(1).rand(BATCH, T_SEQ, HW, HW, 3).astype(np.float32)
    model = trainer.model
    trainer.init_state()
    model.train()
    calls = []
    # A pre-hook: the checkpoint's recompute stops once it has what the
    # backward needs, before the backbone's forward returns.
    model.cnn_backbone.register_forward_pre_hook(lambda *_: calls.append(1))
    y = torch.tensor([1, 3])
    runs = {}
    for remat in (True, False):
        model.remat_backbone = remat
        model.zero_grad(set_to_none=True)
        calls.clear()
        with torch.set_grad_enabled(grad):
            logits = model(torch.from_numpy(x))
            if grad:
                trainer._loss_fn(logits, y, torch.ones(2))[0].backward()
        runs[remat] = (len(calls), logits.detach(),
                       {n: p.grad for n, p in model.named_parameters() if p.grad is not None})
    engaged = finetune and grad
    assert (runs[True][0], runs[False][0]) == ((2, 1) if engaged else (1, 1))
    assert torch.equal(runs[True][1], runs[False][1])
    assert runs[True][2].keys() == runs[False][2].keys()
    assert any(n.startswith("cnn_backbone.") for n in runs[True][2]) == engaged
    for name, g in runs[True][2].items():
        assert torch.equal(g, runs[False][2][name]), name


# ---------------------------------------------------------------------------
# the stem fold


@pytest.mark.parametrize("name", sorted(port._STEM_KERNEL_PATH))
def test_fold_takes_raw_uint8_as_the_plain_backbone_takes_x_over_255(name):
    """Raw uint8 clips through ``backbone_features`` into the folded
    backbone against x / 255 into the plain one, f32, within 1e-4 (vct's
    tolerance and sizes); the argument is left unchanged and a stem bias
    (vgg16, alexnet) is not scaled."""
    size = FOLD_SIZES.get(name, 64)
    backbone, _ = build_backbone(name)
    init_weights(backbone, seed=0)
    backbone.eval()
    before = {k: v.clone() for k, v in backbone.state_dict().items()}
    folded = port.fold_input_scale_into_stem(backbone, name)
    raw = np.random.RandomState(0).randint(0, 256, (1, 2, size, size, 3), np.uint8)
    with torch.no_grad():
        want = backbone_features(backbone, torch.from_numpy(raw).float() / 255.0, torch.float32)
        got = backbone_features(folded, torch.from_numpy(raw), torch.float32)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4, rtol=1e-4)
    for key, value in backbone.state_dict().items():
        assert torch.equal(value, before[key]), key
    stem = ".".join(port._STEM_KERNEL_PATH[name])
    changed = {k for k, v in folded.state_dict().items() if not torch.equal(v, before[k])}
    assert changed == {f"{stem}.weight"}
    torch.testing.assert_close(folded.get_submodule(stem).weight, before[f"{stem}.weight"] / 255.0,
                               rtol=1e-6, atol=0)


def test_raw_uint8_runs_under_bf16_autocast_as_its_bf16_cast():
    """Integer clips are cast to the compute dtype before the backbone: under
    bf16 autocast a uint8 clip gives exactly what the same clip given as
    bf16 gives (0-255 is exact in bf16)."""
    backbone, _ = build_backbone("resnet18")
    init_weights(backbone, seed=0)
    folded = port.fold_input_scale_into_stem(backbone.eval(), "resnet18")
    raw = torch.from_numpy(np.random.RandomState(3).randint(0, 256, (1, 2, 32, 32, 3), np.uint8))
    with torch.no_grad():
        got = backbone_features(folded, raw, torch.bfloat16)
        want = backbone_features(folded, raw.to(torch.bfloat16), torch.bfloat16)
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    assert torch.equal(got, want)


@pytest.mark.parametrize("name", ["resnet18", "vgg16", "alexnet"])
def test_fold_of_a_bridged_backbone_is_the_bridge_of_vct_s_fold(name):
    """The port's fold of a bridged backbone equals, bit for bit, the bridge
    of vct's folded params (vct's non-slow families)."""
    vct_backbone = VCT_BACKBONES.get(name)()
    shapes = jax.eval_shape(vct_backbone.init, jax.random.PRNGKey(0), jnp.ones((1, 64, 64, 3)))
    rng = np.random.RandomState(5)
    variables = jax.tree_util.tree_map(
        lambda s: jnp.asarray(rng.randn(*s.shape).astype(np.float32)), shapes)
    backbone, _ = build_backbone(name)
    load_vct_variables(backbone, variables)
    got = port.fold_input_scale_into_stem(backbone, name)
    want, _ = build_backbone(name)
    load_vct_variables(want, {**variables,
                              "params": vct_port.fold_input_scale_into_stem(variables["params"],
                                                                            name)})
    for (key, a), (_, b) in zip(got.state_dict().items(), want.state_dict().items()):
        assert torch.equal(a, b), key


def test_fold_unknown_backbone_raises_as_vct_does():
    backbone, _ = build_backbone("resnet18")
    with pytest.raises(KeyError, match="No stem path") as got:
        port.fold_input_scale_into_stem(backbone, "resnext")
    with pytest.raises(KeyError) as want:
        vct_port.fold_input_scale_into_stem({}, "resnext")
    assert str(got.value) == str(want.value)


def test_fold_table_is_vct_s():
    """The same eleven families and stem paths as vct's table: every
    registered backbone."""
    assert port._STEM_KERNEL_PATH == vct_port._STEM_KERNEL_PATH
    assert set(port._STEM_KERNEL_PATH) == set(VCT_BACKBONES.names())
