"""vct_torch models against vct's, with weights carried over by the bridge.

Every vct module is initialised in Flax, its variables are perturbed from a
numpy seed (so scales, biases and BN statistics are not their trivial
initial values), loaded into the port through
``vct_torch.bridge.load_vct_variables``, and both run on the same numpy
input in f32 on the CPU (the root conftest pins JAX's matmul precision to
f32). Tolerance: atol = rtol = 1e-4 throughout.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vct.core import config as vct_config
from vct.models import build_model as vct_build_model
from vct.models import layers as vct_layers
from vct.models import ssm as vct_ssm
from vct.models.backbones import build_backbone as vct_build_backbone
from vct_torch.bridge import load_vct_variables
from vct_torch.core import config
from vct_torch.models import build_model, layers, ssm
from vct_torch.models.backbones import build_backbone

TOL = dict(atol=1e-4, rtol=1e-4)


def _perturb(variables, seed=0):
    """numpy copy of a Flax tree with every leaf moved off its init value."""
    rng = np.random.RandomState(seed)

    def move(path, leaf):
        leaf = np.asarray(leaf, np.float32)
        if getattr(path[-1], "key", None) == "var":
            return (1.0 + 0.5 * rng.rand(*leaf.shape)).astype(np.float32)
        scale = 0.1 * (float(leaf.std()) or 1.0)  # 10% of the init spread
        return (leaf + scale * rng.randn(*leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(move, jax.tree_util.tree_map(np.asarray, variables))


def _run_pair(flax_module, torch_module, x, seed=0, **apply_kw):
    variables = _perturb(flax_module.init(jax.random.PRNGKey(0), jnp.asarray(x), **apply_kw), seed)
    want = np.asarray(flax_module.apply(variables, jnp.asarray(x), **apply_kw))
    load_vct_variables(torch_module, variables)
    with torch.no_grad():
        got = torch_module.eval()(torch.from_numpy(x)).numpy()
    return got, want


def _x(*shape, seed=1):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("name", ["resnet18", "resnet50"])
def test_resnet_features_match_vct(name):
    frames = np.random.RandomState(0).rand(2, 32, 32, 3).astype(np.float32)
    flax_bb, feat = vct_build_backbone(name)
    torch_bb, torch_feat = build_backbone(name)
    assert feat == torch_feat
    variables = _perturb(flax_bb.init(jax.random.PRNGKey(0), jnp.asarray(frames)))
    want = np.asarray(flax_bb.apply(variables, jnp.asarray(frames)))
    load_vct_variables(torch_bb, variables)
    with torch.no_grad():
        got = torch_bb.eval()(torch.from_numpy(frames).permute(0, 3, 1, 2)).numpy()
    assert got.shape == (2, feat)
    np.testing.assert_allclose(got, want, **TOL)


def test_rmsnorm_matches_vct():
    got, want = _run_pair(vct_layers.RMSNorm(12), layers.RMSNorm(12), _x(3, 5, 12))
    np.testing.assert_allclose(got, want, **TOL)


def test_canonical_adapter_matches_vct():
    got, want = _run_pair(
        vct_layers.CanonicalAdapter(out_size=8), layers.CanonicalAdapter(64, 8), _x(2, 4, 64)
    )
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("mode", ["lnsd3", "lgn2", "nlr"])
def test_adapt_dsl_matches_vct(mode):
    got, want = _run_pair(
        vct_layers.AdaptDSL(out_size=8, mode=mode), layers.AdaptDSL(64, 8, mode=mode), _x(2, 4, 64)
    )
    np.testing.assert_allclose(got, want, **TOL)


def test_multiclass_head_matches_vct():
    got, want = _run_pair(vct_layers.MulticlassHead(num_classes=5), layers.MulticlassHead(48, 5), _x(3, 48))
    np.testing.assert_allclose(got, want, **TOL)


def test_multibinary_head_matches_vct():
    got, want = _run_pair(vct_layers.MultiBinaryHead(num_classes=5), layers.MultiBinaryHead(48, 5), _x(3, 48))
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("k", [3, 4])
def test_causal_depthwise_conv1d_matches_vct(k):
    x, kernel, bias = _x(2, 9, 6), _x(k, 6, seed=2), _x(6, seed=3)
    want = np.asarray(vct_ssm.causal_depthwise_conv1d(*map(jnp.asarray, (x, kernel, bias))))
    got = ssm.causal_depthwise_conv1d(*map(torch.from_numpy, (x, kernel, bias))).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def _scan_args(B=2, L=10, D=8, N=4, seed=0):
    rng = np.random.RandomState(seed)
    return (
        rng.randn(B, L, D).astype(np.float32),
        (np.abs(rng.randn(B, L, D)) * 0.5).astype(np.float32),
        (-np.abs(rng.randn(D, N))).astype(np.float32),
        rng.randn(B, L, N).astype(np.float32),
        rng.randn(B, L, N).astype(np.float32),
    )


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("impl", ["associative", "scan", "pallas"])
def test_selective_scan_impls_match_vct(impl, reverse):
    args = _scan_args()
    want = np.asarray(vct_ssm.selective_scan(*map(jnp.asarray, args), reverse=reverse, impl=impl))
    got = ssm.selective_scan(*map(torch.from_numpy, args), reverse=reverse, impl=impl).numpy()
    np.testing.assert_allclose(got, want, **TOL)


MAMBA = dict(d_model=8, d_inner=16, n_state=32, dt_rank=32)


@pytest.mark.parametrize("bidirectional", [False, True], ids=["fwd", "bidir"])
@pytest.mark.parametrize("impl", ["associative", "scan", "pallas"])
def test_parallel_mamba_matches_vct(impl, bidirectional):
    kw = dict(MAMBA, bidirectional=bidirectional, scan_impl=impl)
    got, want = _run_pair(vct_ssm.ParallelMamba(**kw), ssm.ParallelMamba(**kw), _x(2, 7, 8))
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("impl", ["associative", "scan", "pallas"])
def test_mamba_residual_block_matches_vct(impl):
    kw = dict(MAMBA, scan_impl=impl)
    got, want = _run_pair(vct_ssm.MambaResidualBlock(**kw), ssm.MambaResidualBlock(**kw), _x(2, 7, 8))
    np.testing.assert_allclose(got, want, **TOL)


def _lrcn_pair(seq_len=8, **overrides):
    kw = dict(num_classes=4, cnn_backbone="resnet18", rnn_type="mamba",
              rnn_input_size=8, rnn_layer=3, scan_impl="pallas")
    kw.update(overrides)
    flax_model = vct_build_model(vct_config.ModelConfig(**kw), seq_len)
    torch_model = build_model(config.ModelConfig(**kw), seq_len, device="cpu")
    return flax_model, torch_model


@pytest.mark.parametrize("classif_mode", ["multiclass", "multiple_binary"])
@pytest.mark.parametrize("rnn_out", ["all", "last"])
def test_lrcn_logits_match_vct(rnn_out, classif_mode):
    flax_model, torch_model = _lrcn_pair(rnn_out=rnn_out, classif_mode=classif_mode)
    x = np.random.RandomState(0).rand(2, 8, 32, 32, 3).astype(np.float32)
    got, want = _run_pair(flax_model, torch_model, x)
    assert got.shape == (2, 4)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("rnn_out", ["all", "last"])
def test_mamba_lrcn_of_hidden_24_matches_vct(rnn_out):
    """n_state = hidden_size = 24, a state size the K3 kernel once refused;
    vct runs its Pallas scan in interpret mode, the port its plain version."""
    flax_model, torch_model = _lrcn_pair(rnn_out=rnn_out, hidden_size=24)
    assert torch_model.mamba_0.mixer.n_state == 24
    x = np.random.RandomState(0).rand(2, 8, 32, 32, 3).astype(np.float32)
    got, want = _run_pair(flax_model, torch_model, x)
    assert got.shape == (2, 4)
    np.testing.assert_allclose(got, want, **TOL)


def test_lrcn_features_only_and_from_features():
    flax_model, torch_model = _lrcn_pair(seq_len=4, use_adapt_dsl=True)
    x = np.random.RandomState(0).rand(2, 4, 32, 32, 3).astype(np.float32)
    variables = _perturb(flax_model.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    load_vct_variables(torch_model, variables)
    feats_want = np.asarray(flax_model.apply(variables, jnp.asarray(x), features_only=True))
    with torch.no_grad():
        feats = torch_model(torch.from_numpy(x), features_only=True)
        logits = torch_model(feats, from_features=True).numpy()
    np.testing.assert_allclose(feats.numpy(), feats_want, **TOL)
    want = np.asarray(flax_model.apply(variables, jnp.asarray(feats_want), from_features=True))
    np.testing.assert_allclose(logits, want, **TOL)


def _small_pair():
    flax_mod = vct_layers.MulticlassHead(num_classes=3)
    variables = jax.tree_util.tree_map(
        np.asarray, flax_mod.init(jax.random.PRNGKey(0), jnp.zeros((1, 16)))
    )
    return variables, layers.MulticlassHead(16, 3)


def test_bridge_missing_leaf_raises_keyerror():
    variables, module = _small_pair()
    del variables["params"]["fcb"]["bias"]
    with pytest.raises(KeyError, match="fcb/bias"):
        load_vct_variables(module, variables)


def test_bridge_extra_leaf_raises_valueerror():
    variables, module = _small_pair()
    variables["params"]["extra"] = {"kernel": np.zeros((2, 2), np.float32)}
    with pytest.raises(ValueError, match="extra"):
        load_vct_variables(module, variables)


def test_bridge_wrong_shape_raises_valueerror():
    variables, module = _small_pair()
    variables["params"]["fc"]["kernel"] = np.zeros((16, 7), np.float32)
    before = module.fc.weight.detach().clone()
    with pytest.raises(ValueError, match="shape"):
        load_vct_variables(module, variables)
    assert torch.equal(module.fc.weight, before)  # nothing written


def test_model_config_defaults_match_vct():
    assert dataclasses.asdict(config.ModelConfig()) == dataclasses.asdict(vct_config.ModelConfig())
    assert config.ModelConfig().resolved_hidden_size == vct_config.ModelConfig().resolved_hidden_size
    ours = dataclasses.asdict(config.DataConfig())
    theirs = dataclasses.asdict(vct_config.DataConfig())
    assert ours == {k: theirs[k] for k in ours}


def test_unknown_backbone_and_family_raise_keyerror():
    with pytest.raises(KeyError, match="resnet50"):
        build_backbone("vgg19")  # a name neither package registers
    with pytest.raises(KeyError, match="lrcn"):
        build_model(config.ModelConfig(model_family="s2vt"), 4, device="cpu")


def test_seeded_weights_are_reproducible():
    cfg = config.ModelConfig(cnn_backbone="resnet18")
    a = build_model(cfg, 4, device="cpu", seed=3).state_dict()
    b = build_model(cfg, 4, device="cpu", seed=3).state_dict()
    c = build_model(cfg, 4, device="cpu", seed=4).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["adapt.adapt1.weight"], c["adapt.adapt1.weight"])


def test_seeded_lecun_weights_are_flax_s_truncated_normal():
    """Conv and linear weights are drawn as Flax's ``lecun_normal``: a
    normal truncated at 2 sigma, scaled to variance 1 / fan_in. Held against
    JAX's own draw by their quantiles and bounds."""
    fan_in, n = 64, 200_000
    want = np.sort(np.asarray(jax.nn.initializers.lecun_normal()(
        jax.random.PRNGKey(0), (fan_in, n // fan_in), jnp.float32)).ravel())
    cfg = config.ModelConfig(cnn_backbone="resnet18")
    model = build_model(cfg, 4, device="cpu", seed=5)
    weight = model.adapt.adapt1.weight.detach().numpy()  # a Linear, (out, fan_in)
    got = np.sort(weight.ravel()) * np.sqrt(weight.shape[1])
    want = want * np.sqrt(fan_in)
    bound = 2 / 0.87962566103423978
    assert np.abs(got).max() <= bound * (1 + 1e-6)
    assert np.abs(want).max() <= bound * (1 + 1e-6)
    qs = [0.01, 0.1, 0.25, 0.5, 0.75, 0.9, 0.99]
    np.testing.assert_allclose(np.quantile(got, qs), np.quantile(want, qs), atol=0.03)
    assert abs(got.std() - 1) < 0.01 and abs(want.std() - 1) < 0.01
    for name, w in model.named_parameters():
        if name.endswith("weight") and w.dim() == 4:  # every conv
            assert w.abs().max() * np.sqrt(np.prod(w.shape[1:])) <= bound * (1 + 1e-5), name
