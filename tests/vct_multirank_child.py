"""``vct``'s mesh results for the port's multi-device tests, in a process
of its own on a virtual 8-device CPU mesh (the tier-1 lane's JAX sees one
CPU device):

    python tests/vct_multirank_child.py DIR            # train steps
    python tests/vct_multirank_child.py DIR classify   # classify_videos
    python tests/vct_multirank_child.py DIR state      # a train state

Train steps (``tests/test_torch_multirank.py``): ``DIR/vct_inputs.pkl``
holds the variables (numpy), the class weights and the cases;
``DIR/vct_steps.pkl`` gets each case's loss, metrics and parameters after
one step. Classify (``tests/test_torch_parallel.py``): ``DIR/vct_classify
.pkl`` holds the overrides, the variables, the clips and the batch size;
``DIR/vct_probs.pkl`` gets the probabilities over a (4, 2) mesh. State
(``tests/test_torch_convert.py``): ``DIR/vct_state.pkl`` holds the
overrides, the variables and the data; vct trains one epoch on a (4, 2)
mesh with ``train.resume`` into ``DIR/vct_state`` (the train state the test
converts) and writes its parameters, epoch loss and step to
``DIR/vct_saved.pkl``.
"""

from __future__ import annotations

import os
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np

from vct.core.config import Config
from vct.parallel.mesh import make_mesh
from vct.parallel.shard import shard_state_like_params
from vct.train import engine


def _state(trainer, variables):
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    extra = {k: jax.tree_util.tree_map(jnp.asarray, v) for k, v in variables.items()
             if k != "params"}
    return engine.host_to_device(engine.TrainState(
        step=jnp.zeros((), jnp.int32), params=params, extra_vars=extra,
        opt_state=trainer._tx.init(params), rng=jax.random.PRNGKey(0)), trainer.mesh)


def classify(out: str) -> None:
    from vct.models import build_model
    from vct.serve.deployment import classify_videos

    with open(os.path.join(out, "vct_classify.pkl"), "rb") as f:
        inputs = pickle.load(f)
    cfg = Config().replace(**inputs["overrides"])
    model = build_model(cfg.model, cfg.data.sequence_length)
    mesh = make_mesh(jax.devices()[:8], data=4, model=2)
    probs = classify_videos(model, inputs["variables"], inputs["clips"],
                            batch_size=inputs["batch_size"], mesh=mesh)
    with open(os.path.join(out, "vct_probs.pkl"), "wb") as f:
        pickle.dump(np.asarray(probs), f)


def save_state(out: str) -> None:
    with open(os.path.join(out, "vct_state.pkl"), "rb") as f:
        inputs = pickle.load(f)
    mesh = make_mesh(jax.devices()[:8], data=4, model=2)
    cfg = Config().replace(**inputs["overrides"], **{
        "train.model_path": os.path.join(out, "vct_state"), "train.epochs": "1"})
    trainer = engine.Trainer(cfg, inputs["names"], mesh=mesh)
    state = shard_state_like_params(_state(trainer, inputs["variables"]), mesh)
    state, run = trainer.fit(state, inputs["x"], inputs["y"], log=False)
    with open(os.path.join(out, "vct_saved.pkl"), "wb") as f:
        pickle.dump({"params": jax.tree_util.tree_map(np.asarray, jax.device_get(state.params)),
                     "epoch_losses": run.epoch_losses, "step": int(state.step)}, f)


def main() -> int:
    out = sys.argv[1]
    if sys.argv[2:] == ["classify"]:
        classify(out)
        return 0
    if sys.argv[2:] == ["state"]:
        save_state(out)
        return 0
    with open(os.path.join(out, "vct_inputs.pkl"), "rb") as f:
        inputs = pickle.load(f)
    results = {}
    for case in inputs["cases"]:
        cfg = Config().replace(**case["overrides"])
        data, model = case["data"], case["model"]
        mesh = make_mesh(jax.devices()[:data * model], data=data, model=model)
        trainer = engine.Trainer(cfg, inputs["names"], mesh=mesh,
                                 class_weights=inputs["class_weights"])
        state = shard_state_like_params(_state(trainer, inputs["variables"]), mesh)
        step = trainer._build_train_step()
        padded = trainer._pad_batch(case["x"], case["y"], case["mask"])
        state, loss, correct, total = step(
            state, *trainer._put_batch(*padded, engine.batch_sharding(mesh)))
        results[case["name"]] = {
            "loss": float(loss), "correct": float(correct), "total": float(total),
            "params": jax.tree_util.tree_map(np.asarray, jax.device_get(state.params))}
    with open(os.path.join(out, "vct_steps.pkl"), "wb") as f:
        pickle.dump(results, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
