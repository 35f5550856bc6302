"""Five Adam steps of vct_torch's caption trainer against vct's compiled
train step, on the CPU.

For all five captioners at the small size of tests/torch_caption_common.py
(one seeded variables tree in both, through the bridge; dropout 0), at
vct's learning rate with global-norm clipping (a clip that binds, 0.05, or
vct's 5.0), with and without the feature cache: each step's loss within
rtol 1e-5 and every parameter after the five within atol = rtol = 1e-5,
except the attention's key biases (see ZERO_GRADIENT), held within Adam's
2 lr a step.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_caption_common as common
from vct.caption import train as vct_train
from vct_torch.bridge import load_vct_variables
from vct_torch.caption.train import CaptionTrainer

GRAD_TOL = 1e-5
# The attention's key biases have an exactly zero gradient (softmax ignores a
# shift of all scores): what either framework computes there is f32 noise,
# whose sign Adam's normalised step follows.
ZERO_GRADIENT = ".key.bias"


def _mask():
    mask = np.ones(common.B, np.float32)
    mask[-1] = 0.0
    return mask


@pytest.mark.parametrize("kind,feature_cache,grad_clip", [
    ("s2vt", False, 5.0), ("s2vt", True, 0.05), ("1s2vt", True, 5.0),
    ("transformer", False, 0.05), ("v1_lstm", False, 0.05), ("v1_gru", False, 5.0),
])
def test_five_adam_steps_match_vct(kind, feature_cache, grad_clip):
    extra = dict(grad_clip=grad_clip, feature_cache=feature_cache)
    vct_model, variables, _, cfg_t = common.pair(kind, **extra)
    cfg_v, _ = common.configs(kind, **extra)
    vct_trainer = vct_train.CaptionTrainer(cfg_v, common.vocab())
    vct_trainer._feature_mode = feature_cache
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    state_v = vct_train.CaptionState(
        step=jnp.zeros((), jnp.int32), params=params,
        extra_vars={k: jax.tree_util.tree_map(jnp.asarray, v) for k, v in variables.items()
                    if k != "params"},
        opt_state=vct_trainer._tx.init(params), rng=jax.random.PRNGKey(0))
    step_v = vct_trainer._build_train_step()
    trainer = CaptionTrainer(cfg_t, common.vocab(), device="cpu")
    load_vct_variables(trainer.model, variables)
    trainer._feature_mode = feature_cache
    state_t = trainer.init_state()
    videos, captions = common.inputs()
    if feature_cache:  # the cached backbone features both train from
        videos = np.array(vct_model.apply(variables, jnp.asarray(videos),
                                          method=vct_model.extract_features))
        got_feats = trainer.model.extract_features(torch.from_numpy(common.inputs()[0]))
        np.testing.assert_allclose(got_feats.numpy(), videos, atol=1e-5, rtol=1e-5)
    rng = np.random.RandomState(5)
    for step in range(5):
        caps = captions[rng.permutation(common.B)]
        mask = _mask() if step % 2 else np.ones(common.B, np.float32)
        state_v, want, _ = step_v(state_v, jnp.asarray(videos), jnp.asarray(caps),
                                  jnp.asarray(mask))
        got, _ = trainer._train_step(state_t, *trainer._put_batch(videos, caps, mask))
        np.testing.assert_allclose(got.item(), float(want), rtol=GRAD_TOL, err_msg=f"step {step}")
    assert state_t.step == 5 and int(state_v.step) == 5
    clone = copy.deepcopy(trainer.model)  # vct's parameters in the port's layout
    load_vct_variables(clone, {**variables,
                               "params": jax.tree_util.tree_map(np.asarray, state_v.params)})
    want_params = {n: p.detach() for n, p in clone.named_parameters()}
    for name, p in trainer.model.named_parameters():
        err = (p.detach() - want_params[name]).abs()
        if name.endswith(ZERO_GRADIENT):
            assert (err <= 2 * cfg_t.learning_rate * 5).all(), (kind, name)
        else:
            assert (err <= GRAD_TOL + GRAD_TOL * want_params[name].abs()).all(), (kind, name)
