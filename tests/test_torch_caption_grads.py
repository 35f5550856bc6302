"""The loss and the gradients of vct_torch's captioners against ``jax.vjp``
of vct's, on the CPU.

For all five captioners at the small size of tests/torch_caption_common.py
(one seeded variables tree in both, through the bridge; dropout 0): the
loss (``_token_nll``: logit i against target i, <pad> ignored, a padding
row masked) within 1e-5 of its magnitude, and every trained parameter's
gradient within 1e-5 of its largest magnitude, that magnitude taken as at
least FLOOR of the model's largest gradient; the backbone gets none (vct's
stop_gradient).
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
# A gradient's largest magnitude is taken as at least FLOOR of the model's
# largest: the two frameworks' f32 sums part by up to about 5e-7 of the
# model's largest gradient in any tensor, so a tensor whose gradient is small
# against the rest (the attention's key biases, exactly zero since softmax
# ignores a shift of all scores; the v1 decoder's, about 2e-3 of the largest)
# is held within 1e-6 of the model's largest gradient.
FLOOR = 0.1


@pytest.mark.parametrize("kind", list(common.KINDS))
def test_loss_and_gradients_match_vct(kind):
    vct_model, variables, _, cfg_t = common.pair(kind)
    videos, captions = common.inputs()
    mask = np.ones(common.B, np.float32)
    mask[-1] = 0.0  # a padding row
    extra = {k: v for k, v in variables.items() if k != "params"}

    def loss_of(params):
        logp = vct_model.apply({"params": params, **extra}, jnp.asarray(videos),
                               jnp.asarray(captions), deterministic=False,
                               rngs={"dropout": jax.random.PRNGKey(1)})
        return vct_train.CaptionTrainer._token_nll(logp, jnp.asarray(captions),
                                                   jnp.asarray(mask))[0]

    want, vjp = jax.vjp(loss_of, jax.tree_util.tree_map(jnp.asarray, variables["params"]))
    (grads,) = vjp(jnp.ones((), jnp.float32))
    trainer = CaptionTrainer(cfg_t, common.vocab(), device="cpu")
    load_vct_variables(trainer.model, variables)
    trainer.model.train()
    video, caps, rows = trainer._put_batch(videos, captions, mask)
    got, count = trainer._token_nll(trainer._forward(video, caps), caps, rows)
    assert count.item() == float(np.sum((captions != 0)[:-1]))
    assert abs(got.item() - float(want)) <= GRAD_TOL * abs(float(want)), (got.item(), want)
    got_grads = torch.autograd.grad(got, trainer._trained)
    names = [n for n, p in trainer.model.named_parameters() if p.requires_grad]
    clone = copy.deepcopy(trainer.model)  # vct's gradients in the port's layout
    load_vct_variables(clone, {**variables, "params": jax.tree_util.tree_map(np.asarray, grads)})
    want_grads = {n: p.detach() for n, p in clone.named_parameters()}
    largest = max(want_grads[n].abs().max() for n in names)
    for name, g in zip(names, got_grads):
        w = want_grads[name]
        scale = max(w.abs().max(), FLOOR * largest)
        assert (g - w).abs().max() <= GRAD_TOL * scale, (kind, name)
    for name, g in want_grads.items():
        if name.startswith("cnn.cnn."):
            assert not g.any(), name  # stop_gradient: the backbone gets nothing
