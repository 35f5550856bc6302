"""Every backbone of vct_torch against vct's, on the CPU.

Each of the eleven registered backbones is built in both packages; vct's
variables tree is shaped by ``jax.eval_shape`` of its init (no Flax init
runs) and filled from a numpy seed, BatchNorm statistics included (means
N(0, 0.01), variances in [1, 1.5), scales near 1, so that a BatchNorm left
at another epsilon than vct's shows), and loaded into the port through
``vct_torch.bridge.load_vct_variables``. Both run the same numpy frames in
f32 (the root conftest pins JAX's matmul precision to f32), at an even and
an odd size: 32/33 px, AlexNet 63/64 px (its three 3x3 stride-2 pools need
63) and Inception-V3 75/76 px (its least input). Tolerance: features within
atol = rtol = 1e-4 of vct's.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vct.models.backbones import BACKBONES as VCT_BACKBONES
from vct.models.backbones import build_backbone as vct_build_backbone
from vct_torch.bridge import load_vct_variables
from vct_torch.models.backbones import BACKBONES, build_backbone

TOL = dict(atol=1e-4, rtol=1e-4)
SIZES = {"alexnet": (63, 64), "inception_v3": (75, 76)}
NAMES = ["resnet18", "resnet34", "resnet50", "resnet101", "resnet152", "mobilenet_v2",
         "densenet121", "vgg16", "alexnet", "efficientnet_b0", "inception_v3"]


def random_variables(flax_module, x, seed=0):
    """A numpy variables tree for ``flax_module`` from a seed, shaped by
    ``jax.eval_shape`` of its init: kernels N(0, 1/fan_in), scales near 1,
    BatchNorm means N(0, 0.01) and variances in [1, 1.5), biases N(0, 0.01)."""
    shapes = jax.eval_shape(flax_module.init, jax.random.PRNGKey(0), jnp.asarray(x[:1]))
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


@functools.lru_cache(maxsize=None)
def _vct_pair(name):
    """vct's backbone and its seeded variables (their shapes do not depend
    on the input size), shared by the even and odd cases."""
    flax_bb, feat = vct_build_backbone(name)
    size = SIZES.get(name, (32, 33))[0]
    return flax_bb, feat, random_variables(flax_bb, np.zeros((1, size, size, 3), np.float32))


def test_the_registry_holds_vcts_names():
    assert BACKBONES.names() == VCT_BACKBONES.names() == sorted(NAMES)


@pytest.mark.parametrize("odd", [False, True], ids=["even", "odd"])
@pytest.mark.parametrize("name", NAMES)
def test_backbone_features_match_vct(name, odd):
    size = SIZES.get(name, (32, 33))[odd]
    frames = np.random.RandomState(1).rand(2, size, size, 3).astype(np.float32)
    flax_bb, feat, variables = _vct_pair(name)
    torch_bb, torch_feat = build_backbone(name)
    assert feat == torch_feat
    want = np.asarray(jax.jit(flax_bb.apply)(variables, jnp.asarray(frames)))
    load_vct_variables(torch_bb, variables)
    with torch.no_grad():
        got = torch_bb.eval()(torch.from_numpy(frames).permute(0, 3, 1, 2)).numpy()
    assert got.shape == (2, feat)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("name", ["mobilenet_v2", "efficientnet_b0", "inception_v3"])
def test_backbone_batchnorm_keeps_running_statistics_in_train_mode(name):
    """Frozen like vct's: ``train()`` leaves every BatchNorm at its running
    statistics, so the features do not change with the mode."""
    size = SIZES.get(name, (32, 33))[0]
    torch_bb, _ = build_backbone(name)
    with torch.no_grad():
        for m in torch_bb.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_var.uniform_(1.0, 1.5)
        x = torch.rand(2, 3, size, size, generator=torch.Generator().manual_seed(0))
        want = torch_bb.eval()(x)
        got = torch_bb.train()(x)
    assert torch.equal(got, want)
    assert not any(m.training for m in torch_bb.modules() if isinstance(m, torch.nn.BatchNorm2d))


def test_vgg_adaptive_pool_repeats_rows_as_vct_does_at_80px():
    """At 80x80 VGG16's last map is 2x2 and the 7x7 pool repeats its rows:
    the port's windows against vct's general branch (1e-6: the same means,
    summed in another order)."""
    from vct.models.backbones.vgg import _adaptive_avg_pool

    x = np.random.RandomState(2).randn(2, 2, 2, 5).astype(np.float32)
    want = np.asarray(_adaptive_avg_pool(jnp.asarray(x), 7, 7))
    got = torch.nn.functional.adaptive_avg_pool2d(
        torch.from_numpy(x).permute(0, 3, 1, 2), 7).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
    x = np.random.RandomState(3).randn(1, 5, 3, 4).astype(np.float32)  # overlapping windows
    want = np.asarray(_adaptive_avg_pool(jnp.asarray(x), 7, 7))
    got = torch.nn.functional.adaptive_avg_pool2d(
        torch.from_numpy(x).permute(0, 3, 1, 2), 7).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
