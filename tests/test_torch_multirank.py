"""Training across ranks on the CPU: gloo worlds of spawned CPU ranks stand
in for the cards (``vct_torch.tools.dryrun.run_world``; the ranks' code is
``tests/torch_multirank_child.py``). One module fixture starts every world
at once, with ``vct``'s mesh steps beside them in a process of their own on a
virtual 8-device CPU mesh (``tests/vct_multirank_child.py``), and returns
the results; the tests hold them.

- One train step of ``vct``'s dryrun config (resnet18, Mamba head, T = 4,
  32x32, ``seq_shard`` on) with class weights and a global batch of 6 at
  (data 2, model 2) and (data 4, model 1), so the denominators differ between
  ranks and (4, 1) pads two mask-0 rows: loss, ``correct`` and ``total``
  against the port's one-process step on the same global batch and weights
  within rtol = atol = 1e-6 (the metrics exactly), every updated parameter
  within 1e-6 too, except under Adam the elements whose gradient lies below
  1e-4 of its tensor's largest (Adam's first step there is the sign of the
  gradients' rounding, see ``NOISE``), held within 2 lr; and against ``vct``'s step at the same mesh on
  the bridged weights: the loss within ``vct``'s own mesh tolerance (2e-4,
  ``tests/test_engine.py``), the parameters within 1e-5 of each tensor's
  largest outside that noise floor (dropout 0: torch's generator is not
  JAX's).
- Dropout 0.25 at (2, 2) and (4, 1), batch 8 (no padding), against the
  one-process step.
- A feature-cache fit with validation driving the plateau scheduler, then
  ``evaluate`` with the AUC, at (2, 2) and (4, 1) against one process.
- ``dryrun multichip 4`` and ``dryrun multihost 2`` on the CPU.
- A train state written by a (1, 2) mesh after one epoch, restored on 2 ranks
  and on 1 process bit-equal to the file (weights and Adam's moments), and
  the two resumed second epochs bit-equal.
- A 2-trial grid sweep on 2 ranks: every rank sees the same F1s, the
  primary alone writes the store.
"""

from __future__ import annotations

import concurrent.futures
import copy
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_multirank_child as child
from test_torch_train import _random_variables
from vct.core import config as vct_config
from vct.train import engine as vct_engine
from vct_torch.bridge import load_vct_variables
from vct_torch.models import build_model
from vct_torch.tools import dryrun

REPO = Path(__file__).resolve().parents[1]
CLASS_WEIGHTS = np.array([0.5, 1.0, 2.0, 1.5], np.float32)
TOL = 1e-6  # against the port's one-process step
VCT_LOSS_TOL = 2e-4  # vct's own mesh tolerance (tests/test_engine.py)
VCT_PARAM_TOL = 1e-5  # of each tensor's largest magnitude
# Adam's first step is lr * sign(g) wherever |g| >> eps: where g lies within
# its rounding of zero, the step is the sign of that rounding. The rounding
# of vct's and the port's gradients is held below 1e-5 of each tensor's
# largest (the convention of test_torch_train.py); the N-rank gradients sum
# the rows' contributions in another order than one process does, and part
# from the one-process gradients by up to 8e-6 of the tensor's largest
# (measured on these inputs), so against one process the floor is 1e-4.
NOISE = {"vct": 1e-5, "one": 1e-4}
# (name, data, model, batch, overrides); the first two are compared with vct.
CASES = [
    ("adam_2x2", 2, 2, 6, {"model.dropout": "0.0", "train.learning_rate": "1e-3"}),
    ("sgd_4x1", 4, 1, 6, {"model.dropout": "0.0", "train.optimizer": "sgd",
                          "train.learning_rate": "0.05", "train.grad_clip": "0.5"}),
    ("dropout_2x2", 2, 2, 8, {"model.dropout": "0.25", "train.learning_rate": "1e-3"}),
    ("dropout_4x1", 4, 1, 8, {"model.dropout": "0.25", "train.learning_rate": "1e-3"}),
]
VCT_CASES = CASES[:2]


def _batch(rng, n):
    return (rng.rand(n, 4, 32, 32, 3).astype(np.float32),
            rng.randint(0, 4, n).astype(np.int64), np.ones(n, np.float32))


def _vct_steps(root, variables, cases) -> subprocess.Popen:
    """Start ``vct``'s mesh steps in a process of their own, on a virtual
    8-device CPU mesh (``tests/vct_multirank_child.py``)."""
    vct_cases = [{**c, "overrides": {**child.DRYRUN, "train.batch_size": str(c["batch"]),
                                      **c["overrides"]}}
                 for c in cases if c["name"] in dict((n, 0) for n, *_ in VCT_CASES)]
    with open(root / "vct_inputs.pkl", "wb") as f:
        pickle.dump({"variables": variables, "cases": vct_cases, "names": child.NAMES,
                     "class_weights": CLASS_WEIGHTS}, f)
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": str(REPO),
           "XLA_FLAGS": "--xla_force_host_platform_device_count=8"}
    return subprocess.Popen([sys.executable, str(REPO / "tests" / "vct_multirank_child.py"),
                             str(root)], env=env, cwd=str(REPO), stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    root = tmp_path_factory.mktemp("worlds")
    rng = np.random.RandomState(0)
    cfg_t = child.dryrun_cfg(6)
    vct_model = vct_engine.build_model(vct_config.Config().replace(**child.DRYRUN).model, 4)
    variables = _random_variables(vct_model, np.zeros((1, 4, 32, 32, 3), np.float32))
    port = build_model(cfg_t.model, 4, device="cpu")
    load_vct_variables(port, variables)
    weights = {k: v.clone() for k, v in port.state_dict().items()}
    cases = []
    for name, data, model, batch, overrides in CASES:
        x, y, m = _batch(rng, batch)
        cases.append({"name": name, "data": data, "model": model, "batch": batch,
                      "overrides": overrides, "x": x, "y": y, "mask": m})
    steps_dir, resume_dir = root / "steps", root / "resume"
    steps_dir.mkdir()
    resume_dir.mkdir()
    ex, ey, _ = _batch(rng, 10)
    torch.save({"weights": weights, "cases": cases, "class_weights": CLASS_WEIGHTS,
                "eval_x": ex, "eval_y": ey}, steps_dir / "inputs.pt")
    x, y, _ = _batch(rng, 10)
    torch.save({"weights": weights, "x": x, "y": y}, resume_dir / "inputs.pt")
    script = "tests/torch_multirank_child.py"
    vct_proc = _vct_steps(root, variables, cases)
    try:
        with concurrent.futures.ThreadPoolExecutor(4) as pool:
            jobs = {
                "steps": pool.submit(dryrun.run_world, 4, [script, "steps", str(steps_dir)]),
                "resume": pool.submit(dryrun.run_world, 2, [script, "resume",
                                                            str(resume_dir)]),
                "multichip": pool.submit(dryrun.dryrun_multichip, 4, "cpu"),
                "multihost": pool.submit(dryrun.dryrun_multihost, 2, "cpu"),
            }
            done = {k: f.result() for k, f in jobs.items()}
        log, _ = vct_proc.communicate(timeout=600)
    finally:
        if vct_proc.poll() is None:
            vct_proc.kill()
            vct_proc.wait()
    assert vct_proc.returncode == 0, log[-3000:]
    with open(root / "vct_steps.pkl", "rb") as f:
        vct = pickle.load(f)
    return {
        "steps": torch.load(steps_dir / "steps.pt", weights_only=False),
        "resume": torch.load(resume_dir / "resume.pt", weights_only=False),
        "multichip": done["multichip"], "multihost": done["multihost"],
        "vct": vct, "port": port, "variables": variables,
        "lr": {name: float(o.get("train.learning_rate", "1e-4")) for name, *_, o in CASES},
        "adam": {name: o.get("train.optimizer", "adam") != "sgd" for name, *_, o in CASES},
    }


def _hold_params(got: dict, want: dict, grads: dict, tol: float, lr: float, adam: bool,
                 of_largest: bool, noise: float):
    """Every trained parameter within ``tol`` (absolute and relative, or of
    the tensor's largest); under Adam the elements whose gradient lies
    below ``noise`` of its tensor's largest within 2 lr instead."""
    assert got.keys() == want.keys()
    for name in want:
        a, b = got[name], want[name]
        limit = tol * b.abs().max() if of_largest else tol + tol * b.abs()
        close = (a - b).abs() <= limit
        if adam and name in grads:
            g = grads[name].abs()
            noisy = g < noise * g.max()
            assert ((a - b).abs()[noisy] <= 2 * lr + tol).all(), name
            close |= noisy
        assert close.all(), (name, (a - b).abs().max().item())


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_step_across_ranks_equals_the_one_process_step(worlds, name):
    ranks, one = worlds["steps"][name]["ranks"], worlds["steps"][name]["one"]
    np.testing.assert_allclose(ranks["loss"], one["loss"], rtol=TOL, atol=TOL)
    assert (ranks["correct"], ranks["total"]) == (one["correct"], one["total"])
    _hold_params(ranks["params"], one["params"], one["grads"], TOL, worlds["lr"][name],
                 worlds["adam"][name], of_largest=False, noise=NOISE["one"])
    if "2x2" in name:
        assert ranks["specs"], "the (2, 2) mesh shards nothing"


@pytest.mark.parametrize("name", [c[0] for c in VCT_CASES])
def test_step_across_ranks_matches_vcts_mesh_step(worlds, name):
    ranks, want = worlds["steps"][name]["ranks"], worlds["vct"][name]
    np.testing.assert_allclose(ranks["loss"], want["loss"], rtol=VCT_LOSS_TOL,
                               atol=VCT_LOSS_TOL)
    assert (ranks["correct"], ranks["total"]) == (want["correct"], want["total"])
    clone = copy.deepcopy(worlds["port"])
    stats = {k: v for k, v in worlds["variables"].items() if k != "params"}
    load_vct_variables(clone, {"params": want["params"], **stats})
    vct_params = {n: p.detach() for n, p in clone.named_parameters() if n in ranks["params"]}
    _hold_params(ranks["params"], vct_params, ranks["grads"], VCT_PARAM_TOL,
                 worlds["lr"][name], worlds["adam"][name], of_largest=True,
                 noise=NOISE["vct"])


@pytest.mark.parametrize("grid", ["2x2", "4x1"])
def test_validation_feature_cache_and_evaluate_across_ranks(worlds, grid):
    """A feature-cache fit with validation driving the plateau scheduler,
    then the metric block with the AUC, on 10 clips in batches of 6 (padded
    to 8 at (4, 1)): the epoch and validation losses within 1e-6, the same
    learning rate after, the metrics within 1e-6."""
    got = worlds["steps"]["evaluate"][grid]
    ranks, one = got["ranks"], got["one"]
    np.testing.assert_allclose(ranks["epoch_losses"], one["epoch_losses"], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(ranks["val_losses"], one["val_losses"], rtol=TOL, atol=TOL)
    assert ranks["lr"] == one["lr"]
    np.testing.assert_allclose(ranks["metrics"], one["metrics"], rtol=TOL, atol=TOL)


def test_dryruns_on_a_gloo_cpu_world(worlds):
    assert worlds["multichip"].startswith("dryrun_multichip ok: mesh={'data': 2, 'model': 2}")
    assert worlds["multihost"].startswith("dryrun_multihost ok: 2 processes")


def test_train_state_of_two_ranks_resumes_on_one_and_two_bit_equal(worlds):
    got = worlds["resume"]
    assert got["epochs"] == (1, 1)
    assert got["sharded"], "the (1, 2) mesh shards nothing"
    for key in ("restored2_is_file", "restored1_is_file", "moments2_is_file",
                "moments1_is_file", "second_epoch_equal"):
        assert got[key], key
    two, one = got["losses"]
    assert two == one and len(two) == 2


def test_grid_sweep_across_two_ranks(worlds):
    sweep = worlds["resume"]["sweep"]
    first, second = sweep["f1_by_rank"]
    assert first == second and first  # the kept runs' F1s, the same on both ranks
    assert sweep["files"] == ["best", "model", "results.json"]  # compacted: no journal
    assert [e["metrics"]["f1_score"] for e in sweep["stored"]] == first
    assert sweep["best"]["config"] in [e["config"] for e in sweep["stored"]]
