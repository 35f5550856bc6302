"""The ranks of the CPU worlds that ``tests/test_torch_multirank.py`` starts
(``vct_torch.tools.dryrun.run_world``): each world runs every check of its
kind and rank 0 writes the results for the test to hold.

    python tests/torch_multirank_child.py steps DIR   # 4 ranks
    python tests/torch_multirank_child.py resume DIR  # 2 ranks
    python tests/torch_multirank_child.py convert DIR # 4 ranks

``DIR`` holds ``inputs.pt`` (the weights in the port's layout, the batches,
the class weights); rank 0 writes ``DIR/<kind>.pt``. Imports torch and the
port only.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch

from vct_torch.core.config import Config
from vct_torch.parallel import multihost
from vct_torch.parallel.mesh import make_mesh
from vct_torch.parallel.shard import full_tensor
from vct_torch.train.checkpoint import gather_state_dict, load_train_state, load_weights
from vct_torch.train.engine import Trainer

NAMES = [f"class_{i}" for i in range(4)]


# vct's dryrun config (``__graft_entry__.py``), as dotted overrides that
# either package's Config takes.
DRYRUN = {
    "model.cnn_backbone": "resnet18", "model.rnn_type": "mamba",
    "model.rnn_input_size": "8", "model.rnn_layer": "2",
    "data.sequence_length": "4", "data.img_height": "32", "data.img_width": "32",
    "mesh.donate": "false", "model.seq_shard": "true"}


def dryrun_cfg(batch: int, **extra) -> Config:
    return Config().replace(**{**DRYRUN, "train.batch_size": str(batch), **extra})


def _trainer(cfg, weights, mesh, class_weights=None):
    trainer = Trainer(cfg, NAMES, mesh=mesh, class_weights=class_weights)
    load_weights(trainer.model, weights)
    return trainer, trainer.init_state()


def _grads(trainer, state):
    """{name: the whole gradient} of the trained parameters."""
    specs = state.specs or {}
    out = {}
    for name, p in zip(trainer._trained_names, trainer._trained):
        if p.grad is not None:
            out[name] = full_tensor(p.grad, trainer.mesh, specs.get(name)).clone()
    return out


def _step(cfg, weights, mesh, batch, class_weights):
    trainer, state = _trainer(cfg, weights, mesh, class_weights)
    loss, correct, total = trainer._train_step(state, *trainer._put_global(*batch))
    trained = set(trainer._trained_names)
    params = {k: v.clone() for k, v in gather_state_dict(state).items() if k in trained}
    return {"loss": float(loss), "correct": float(correct), "total": float(total),
            "params": params, "grads": _grads(trainer, state), "specs": state.specs or {}}


def steps(out: str) -> None:
    """One train step at each case's mesh, and rank 0's one-process step on
    the same global batch and weights."""
    inputs = torch.load(os.path.join(out, "inputs.pt"), weights_only=False)
    results = {}
    for case in inputs["cases"]:
        cfg = dryrun_cfg(case["batch"], **case["overrides"])
        batch = case["x"], case["y"], case["mask"]
        mesh = make_mesh(data=case["data"], model=case["model"])
        got = _step(cfg, inputs["weights"], mesh, batch, inputs["class_weights"])
        if multihost.is_primary():
            one = _step(cfg, inputs["weights"], make_mesh(["cpu"]), batch,
                        inputs["class_weights"])
            results[case["name"]] = {"ranks": got, "one": one}
        multihost.barrier("case")
    results["evaluate"] = {}
    for data, model in ((2, 2), (4, 1)):
        got = _evaluate(inputs, make_mesh(data=data, model=model))
        if multihost.is_primary():
            results["evaluate"][f"{data}x{model}"] = {
                "ranks": got, "one": _evaluate(inputs, make_mesh(["cpu"]))}
        multihost.barrier("evaluate")
    if multihost.is_primary():
        torch.save(results, os.path.join(out, "steps.pt"))


def _evaluate(inputs, mesh) -> dict:
    """A feature-cache fit with a validation set driving the plateau
    scheduler (2 epochs), then ``evaluate`` with the AUC, over 10 clips in
    batches of 6 (the second padded): every metric a rank computes."""
    x, y = inputs["eval_x"], inputs["eval_y"]
    cfg = dryrun_cfg(6, **{"train.feature_cache": "true", "train.epochs": "2",
                           "train.lr_plateau_factor": "0.5", "train.lr_plateau_patience": "0",
                           "model.dropout": "0.0", "train.learning_rate": "1e-3"})
    trainer, state = _trainer(cfg, inputs["weights"], mesh, inputs["class_weights"])
    state, run = trainer.fit(state, x, y, log=False, val=(x[:7], y[:7]))
    trainer._feature_mode = False
    m = trainer.evaluate(state, x, y, log=False, compute_auc=True)
    return {"epoch_losses": run.epoch_losses, "val_losses": run.val_losses,
            "lr": state.optimizer.param_groups[0]["lr"],
            "metrics": [m.accuracy, m.precision, m.recall, m.f1,
                        m.per_class["__auc__"]["auc"]]}


def _fit(cfg, weights, mesh, x, y):
    trainer, state = _trainer(cfg, weights, mesh)
    state, run = trainer.fit(state, x, y, log=False)
    return trainer, state, run


def _saved_tensors(path):
    saved = torch.load(os.path.join(path, "train_state.pt"), weights_only=True)
    return saved["model"], saved["optimizer"]["state"]


def _whole_moments(state):
    from vct_torch.train.checkpoint import _optimizer_state

    return _optimizer_state(state)["state"]


def _equal(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def resume(out: str) -> None:
    """A (1, 2) mesh writes a train state after epoch 1; it resumes on 2
    ranks and on 1 process (bit-equal restores and second epochs); then a
    2-trial grid sweep across the 2 ranks."""
    inputs = torch.load(os.path.join(out, "inputs.pt"), weights_only=False)
    x, y, weights = inputs["x"], inputs["y"], inputs["weights"]
    ck = os.path.join(out, "ck")
    base = {"train.resume": "true", "train.model_path": ck, "model.dropout": "0.25",
            "train.learning_rate": "1e-3"}
    mesh = make_mesh(data=1, model=2)
    _fit(dryrun_cfg(4, **base, **{"train.epochs": "1"}), weights, mesh, x, y)
    file_model, file_moments = _saved_tensors(ck)
    cfg2 = dryrun_cfg(4, **base, **{"train.epochs": "2"})
    # Restored on 2 ranks: the blocks join back into the file's tensors.
    trainer, state = _trainer(cfg2, weights, mesh)
    state, epoch, _ = load_train_state(ck, state)
    restored2 = gather_state_dict(state)
    moments2 = _whole_moments(state)
    # The second epoch on 2 ranks, from the file (the file is not rewritten
    # until every rank has read it: fit's resume reads before any save).
    resumed = dict(base, **{"train.model_path": os.path.join(out, "ck2")})
    if multihost.is_primary():
        import shutil

        shutil.copytree(ck, resumed["train.model_path"])
    multihost.barrier("copied")
    _, state2, run2 = _fit(dryrun_cfg(4, **resumed, **{"train.epochs": "2"}), weights, mesh, x, y)
    two = gather_state_dict(state2)
    result = None
    if multihost.is_primary():
        one_mesh = make_mesh(["cpu"])
        trainer1, state1 = _trainer(cfg2, weights, one_mesh)
        state1, epoch1, _ = load_train_state(ck, state1)
        restored1 = {k: v.clone() for k, v in state1.model.state_dict().items()}
        moments1 = _whole_moments(state1)
        resumed1 = dict(base, **{"train.model_path": os.path.join(out, "ck1")})
        import shutil

        shutil.copytree(ck, resumed1["train.model_path"])
        _, state1b, run1 = _fit(dryrun_cfg(4, **resumed1, **{"train.epochs": "2"}), weights,
                                one_mesh, x, y)
        one = state1b.model.state_dict()
        result = {
            "epochs": (epoch, epoch1),
            "restored2_is_file": _equal(restored2, file_model),
            "restored1_is_file": _equal(restored1, file_model),
            "moments2_is_file": all(_equal(moments2[i], file_moments[i]) for i in file_moments),
            "moments1_is_file": all(_equal(moments1[i], file_moments[i]) for i in file_moments),
            "second_epoch_equal": _equal(two, dict(one)),
            "losses": (run2.epoch_losses, run1.epoch_losses),
            "sharded": sorted(state.specs or {}),
        }
    multihost.barrier("resumed")
    result_sweep = sweep(out, inputs)
    if multihost.is_primary():
        result["sweep"] = result_sweep
        torch.save(result, os.path.join(out, "resume.pt"))


def sweep(out: str, inputs: dict) -> dict:
    """A 2-trial grid sweep whose trials train across the world's ranks."""
    from vct_torch.sweep.runner import SweepRunner
    from vct_torch.sweep.store import SweepStore
    from vct_torch.sweep.strategies import grid_search

    root = os.path.join(out, "sweep")
    cfg = dryrun_cfg(4, **{
        "train.epochs": "1", "model.rnn_layer": "1",
        "sweep.checkpoint_file": os.path.join(root, "results.json"),
        "sweep.best_model_dir": os.path.join(root, "best"),
        "sweep.f1_threshold": "-1", "train.save_model": "true",
        "train.model_path": os.path.join(root, "model")})
    runner = SweepRunner(cfg, store=SweepStore(cfg.sweep.checkpoint_file),
                         data=(inputs["x"], inputs["y"], NAMES))
    best = grid_search(runner, {"train.learning_rate": [1e-3, 1e-2]})
    if multihost.is_primary():
        runner.store.compact()
    multihost.barrier("swept")
    rank = multihost.process_index()
    mine = json.dumps([e["metrics"]["f1_score"] for e in runner.best_results])
    seen = [json.loads(x) for x in _exchange(mine)]
    return {"best": best, "f1_by_rank": seen, "rank": rank,
            "files": sorted(os.listdir(root)),
            "stored": json.load(open(cfg.sweep.checkpoint_file))}


def _exchange(text: str) -> list:
    """Every rank's ``text``, in rank order (gloo's all_gather_object)."""
    gathered = [None] * multihost.process_count()
    torch.distributed.all_gather_object(gathered, text)
    return gathered


def convert(out: str) -> None:
    """A train state converted from vct (``DIR/port``, copied to
    ``DIR/port_ranks``) resumed to epoch 2 on a (2, 2) mesh; rank 0 writes
    the whole parameters and the epoch losses to ``DIR/convert.pt``."""
    inputs = torch.load(os.path.join(out, "port_inputs.pt"), weights_only=False)
    cfg = Config().replace(**inputs["overrides"], **{
        "train.model_path": os.path.join(out, "port_ranks"), "train.epochs": "2"})
    trainer = Trainer(cfg, NAMES, mesh=make_mesh(data=2, model=2))
    state, run = trainer.fit(trainer.init_state(), inputs["x"], inputs["y"], log=False)
    params = gather_state_dict(state)
    if multihost.is_primary():
        torch.save({"params": params, "epoch_losses": run.epoch_losses, "step": state.step,
                    "sharded": sorted(state.specs or {})}, os.path.join(out, "convert.pt"))


def main() -> int:
    kind, out = sys.argv[1], sys.argv[2]
    multihost.initialize(device="cpu")
    {"steps": steps, "resume": resume, "convert": convert}[kind](out)
    multihost.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
