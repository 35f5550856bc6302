"""vct_torch's scratch CNN families (``lrcn2``, ``td_cnn_lstm``) against
vct's, on the CPU.

vct's variables are shaped by ``jax.eval_shape`` and filled from a numpy
seed (BatchNorm statistics off (0, 1)), then loaded into the port by
``vct_torch.bridge.load_vct_variables``; both run the same numpy clips in
f32. Tolerances: logits atol = rtol = 1e-4 (f32, other summation orders);
LRCN2's train-mode BatchNorm (batch statistics, Flax's running update)
outputs and running statistics atol = rtol = 1e-5.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_train import _configs, _random_variables
from vct.train import engine as vct_engine
from vct_torch.bridge import load_vct_variables
from vct_torch.models import LRCN2, TimeDistributedCNNLSTM, build_model
from vct_torch.models.scratch_cnn import _BatchStatsNorm

T_SEQ = 4


@pytest.mark.parametrize("hw", [(32, 32), (20, 28)], ids=["32x32", "20x28"])
@pytest.mark.parametrize("family", ["lrcn2", "td_cnn_lstm"])
def test_scratch_cnn_logits_match_vct(family, hw):
    overrides = {"model.model_family": family, "model.hidden_size": "6",
                 "data.sequence_length": str(T_SEQ), "data.img_height": str(hw[0]),
                 "data.img_width": str(hw[1])}
    cfg_v, cfg_t = _configs(**overrides)
    vct_model = vct_engine.build_model(cfg_v.model, T_SEQ)
    port = build_model(cfg_t.model, T_SEQ, device="cpu", frame_size=hw)
    assert isinstance(port, LRCN2 if family == "lrcn2" else TimeDistributedCNNLSTM)
    x = np.random.RandomState(1).rand(2, T_SEQ, *hw, 3).astype(np.float32)
    variables = _random_variables(vct_model, x)
    want = np.asarray(jax.jit(vct_model.apply)(variables, jnp.asarray(x)))
    load_vct_variables(port, variables)
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == (2, cfg_t.model.num_classes)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_lrcn2_needs_the_frame_size():
    cfg = _configs(**{"model.model_family": "lrcn2"})[1]
    with pytest.raises(ValueError, match="frame_size"):
        build_model(cfg.model, T_SEQ, device="cpu")


def test_lrcn2_batchnorm_trains_on_batch_statistics_as_vct_does():
    """Two train-mode calls: outputs from the batch's statistics, the running
    ones updated by Flax's rule (0.9 running + 0.1 batch, the batch variance
    biased); then eval mode reads the running ones."""
    rng = np.random.RandomState(0)
    x = [(2.0 + 3.0 * rng.randn(4, 5, 6, 3)).astype(np.float32) for _ in range(2)]
    flax_bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    variables = jax.tree_util.tree_map(np.asarray, flax_bn.init(jax.random.PRNGKey(0), x[0]))
    variables["params"]["scale"] = (1 + 0.1 * rng.randn(3)).astype(np.float32)
    variables["params"]["bias"] = (0.1 * rng.randn(3)).astype(np.float32)
    bn = _BatchStatsNorm(3, eps=1e-5)
    load_vct_variables(bn, variables)
    bn.train()
    for xi in x:
        want, updates = flax_bn.apply(variables, jnp.asarray(xi), mutable=["batch_stats"])
        variables = {**variables, **jax.tree_util.tree_map(np.asarray, updates)}
        with torch.no_grad():
            got = bn(torch.from_numpy(xi).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(bn.running_mean.numpy(), variables["batch_stats"]["mean"],
                                   atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(bn.running_var.numpy(), variables["batch_stats"]["var"],
                                   atol=1e-5, rtol=1e-5)
    want = fnn.BatchNorm(use_running_average=True, epsilon=1e-5).apply(variables,
                                                                        jnp.asarray(x[0]))
    with torch.no_grad():
        got = bn.eval()(torch.from_numpy(x[0]).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
