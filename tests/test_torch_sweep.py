"""vct_torch's sweep against vct's, on the CPU.

The space, the store and the three strategies are held byte for byte: the
same seeds and objective values must propose the same configurations in the
same order, print the same lines and leave the same store, trial-journal and
GA-checkpoint files, and a sweep one package interrupted must resume in the
other to the same end. The strategies run on stub trials that score a
configuration by a fixed function, in both packages (``_train_once``
replaced, so the runner's own recording runs). One real trial runs through
each package's runner at the small geometry of tests/test_torch_train.py,
the port's from vct's initial variables (carried by
``vct_torch.bridge.load_vct_variables``): its classification metrics must be
equal and its epoch losses within atol 1e-5. vct's side runs as
tests/test_sweep.py runs it.
"""

import contextlib
import dataclasses
import io
import json
import math
import random
import shutil
import types

import jax
import numpy as np
import pytest
import torch

import vct.utils.compilecache
from vct.core.config import Config as VctConfig
from vct.core.metrics_contract import RunMetrics as VctRunMetrics
from vct.sweep import __main__ as vct_cli
from vct.sweep import runner as vct_runner
from vct.sweep import space as vct_space
from vct.sweep import store as vct_store
from vct.sweep import strategies as vct_strategies
from vct.train import engine as vct_engine
from vct_torch.bridge import load_vct_variables
from vct_torch.core.config import Config
from vct_torch.core.metrics_contract import RunMetrics, extract_metrics
from vct_torch.data.clipcache import write_clipcache
from vct_torch.data.synthetic import generate_dummy_data
from vct_torch.sweep import __main__ as cli
from vct_torch.sweep import runner, space, store, strategies
from vct_torch.train import engine
from vct_torch.train.checkpoint import load_checkpoint

VCT = types.SimpleNamespace(name="vct", runner=vct_runner, space=vct_space, store=vct_store,
                            strategies=vct_strategies, Config=VctConfig, RunMetrics=VctRunMetrics,
                            device={})
PORT = types.SimpleNamespace(name="port", runner=runner, space=space, store=store,
                             strategies=strategies, Config=Config, RunMetrics=RunMetrics,
                             device={"device": "cpu"})
PACKAGES = (VCT, PORT)

T_SEQ, HW, CLASSES = 4, 32, 4
# tests/test_torch_train.py's small LRCN (resnet18, rnn_input 8, H 6, 2 layers, K2's path).
SMALL = {"model.cnn_backbone": "resnet18", "model.rnn_input_size": "8",
         "model.hidden_size": "6", "model.rnn_layer": "2", "model.scan_impl": "pallas",
         "model.dropout": "0.0", "data.sequence_length": str(T_SEQ),
         "data.img_height": str(HW), "data.img_width": str(HW), "train.batch_size": "4"}
LOSS_ATOL = 1e-5

# Every kind of dimension: choices, categorical dict, int with and without a
# step, float, log float.
SPACE = {
    "model.rnn_type": ["lstm", "gru", "mamba"],
    "train.batch_size": {"type": "categorical", "choices": [8, 16]},
    "model.hidden_size": {"type": "int", "low": 8, "high": 64},
    "model.rnn_layer": {"type": "int", "low": 1, "high": 5, "step": 2},
    "model.dropout": {"type": "float", "low": 0.0, "high": 0.5},
    "train.learning_rate": {"type": "float", "low": 1e-5, "high": 1e-2, "log": True},
}
GRID = {key: SPACE[key] for key in ("model.rnn_type", "train.batch_size", "model.hidden_size",
                                    "model.rnn_layer")}


def _captured(fn, *args, **kwargs):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = fn(*args, **kwargs)
    return result, out.getvalue()


def _files(root):
    """Every file under ``root``: relative path -> bytes."""
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*"))
            if p.is_file()}


# ---------------------------------------------------------------------------
# space


@pytest.mark.parametrize("seed", [0, 7])
def test_space_draws_the_same_points_as_vct(seed):
    def draws(mod):
        rng = random.Random(seed)
        dims = mod.normalize_space(SPACE)
        points = [mod.sample_point(dims, rng) for _ in range(40)]
        mutated = [d.mutate(None, rng) for d in dims for _ in range(4)]
        grid = list(mod.grid_points(mod.normalize_space(GRID)))
        return points, mutated, grid, rng.getstate()

    assert draws(space) == draws(vct_space)


def test_space_refuses_what_vct_refuses():
    for bad in ({"model.dropout": {"type": "float", "low": 0.0, "high": 0.5}},
                {"model.hidden_size": 5}):
        with pytest.raises(ValueError) as want:
            list(vct_space.grid_points(vct_space.normalize_space(bad)))
        with pytest.raises(ValueError) as got:
            list(space.grid_points(space.normalize_space(bad)))
        assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# store


def _store_script(mod, root):
    """Appends past a compaction, a torn tail, an append after it, reads,
    an explicit compaction; then an invalid canonical file. Returns what
    each step read and printed, and the files after each step."""
    s = mod.SweepStore(str(root / "sweep" / "ckpt.json"))
    seen = []
    for i in range(mod.COMPACT_EVERY + 7):
        s.append({"config": {"i": i, "lr": 10.0 ** -(i % 5)},
                  "metrics": {"f1_score": (i * 37 % 61) / 61}, "best_model_filename": None})
    seen.append(_files(root))
    with open(s.journal_path, "a") as f:
        f.write('{"config": {"i": 999')  # a crash mid-append
    seen.append(_captured(s.load))
    s.append({"config": {"i": 1000}, "metrics": {"f1_score": 0.5}})
    seen += [_captured(s.load), s.best(), s.completed_configs(), _files(root)]
    s.compact()
    seen.append(_files(root))
    bad = root / "bad.json"
    bad.write_text("{invalid")
    b = mod.SweepStore(str(bad))
    seen.append(_captured(b.load))
    b.append({"config": {"a": 1}, "metrics": {"f1_score": 0.1}})
    b.compact()
    seen.append(_files(root))
    seen.append(mod.is_config_duplicate(s.completed_configs(), {"i": 3, "lr": 0.01}))
    return seen


def test_store_writes_the_same_bytes_as_vct(tmp_path):
    (tmp_path / "vct").mkdir()
    (tmp_path / "port").mkdir()
    assert _store_script(store, tmp_path / "port") == _store_script(vct_store, tmp_path / "vct")


@pytest.mark.parametrize("writer,resumer", [(VCT, PORT), (PORT, VCT)], ids=["vct-port", "port-vct"])
def test_a_store_resumes_across_packages(tmp_path, writer, resumer):
    """A store one package left mid-journal (a torn tail too) reads and
    grows in the other exactly as in the first."""
    first = tmp_path / "first"
    s = writer.store.SweepStore(str(first / "ckpt.json"))
    for i in range(12):
        s.append({"config": {"i": i}, "metrics": {"f1_score": i / 12}})
    with open(s.journal_path, "a") as f:
        f.write('{"config": {"i": 9')
    ends = []
    for pkg in (writer, resumer):
        root = tmp_path / pkg.name
        shutil.copytree(first, root)
        s = pkg.store.SweepStore(str(root / "ckpt.json"))
        loaded = _captured(s.load)
        for i in range(12, 60):
            s.append({"config": {"i": i}, "metrics": {"f1_score": (i % 7) / 7}})
        ends.append((loaded, s.best(), _files(root)))
    assert ends[1] == ends[0]


# ---------------------------------------------------------------------------
# strategies, on stub trials


def _score(cfg) -> float:
    """A fixed objective over a configuration: one peak in each dimension."""
    return (1.0 - abs(cfg.model.hidden_size - 40) / 64
            - abs(math.log10(cfg.train.learning_rate) + 3) / 8
            - 0.05 * abs(cfg.model.rnn_layer - 3)
            + {"lstm": 0.02, "gru": 0.0, "mamba": -0.02}[cfg.model.rnn_type])


def _stub_runner(pkg, root, calls, threshold="0.5"):
    """``pkg``'s SweepRunner whose trials return ``_score`` as F1 and log the
    configurations proposed."""
    class Stub(pkg.runner.SweepRunner):
        def _train_once(self, cfg):
            return pkg.RunMetrics(f1=_score(cfg), accuracy=0.5)

        def run_training(self, config, test_runs=None):
            calls.append(dict(config))
            return super().run_training(config, test_runs)

    cfg = pkg.Config().replace(**{
        "sweep.checkpoint_file": str(root / "ckpt.json"),
        "sweep.best_model_dir": str(root / "best"),
        "sweep.f1_threshold": threshold, "sweep.test_runs": "1",
        "train.model_path": str(root / "no_model"),
    })
    return Stub(cfg, store=pkg.store.SweepStore(cfg.sweep.checkpoint_file), **pkg.device)


TPE_SPACE = {"model.hidden_size": {"type": "int", "low": 8, "high": 64},
             "train.learning_rate": {"type": "float", "low": 1e-5, "high": 1e-1, "log": True},
             "model.rnn_type": ["lstm", "gru", "mamba"]}
GA_SPACE = {"model.hidden_size": {"type": "int", "low": 8, "high": 64, "step": 4},
            "model.rnn_layer": {"type": "int", "low": 1, "high": 5},
            "train.learning_rate": {"type": "float", "low": 1e-4, "high": 1e-2, "log": True},
            "model.rnn_type": ["lstm", "gru", "mamba"]}
GRID_SPACE = {"model.rnn_type": ["lstm", "gru"], "model.hidden_size": [16, 40],
              "model.rnn_layer": {"type": "int", "low": 1, "high": 5, "step": 2}}


def _sweep(name, pkg, r, end):
    """Run strategy ``name`` to ``end`` (trials, generations or grid points)."""
    s = pkg.strategies
    if name == "grid":
        return s.grid_search(r, GRID_SPACE, max_trials=end)
    if name.startswith("bayesian"):
        return s.bayesian_optimization(r, TPE_SPACE, n_trials=end, n_warmup=6, seed=3)
    return s.genetic_algorithm(r, GA_SPACE, population_size=6, generations=end, seed=1)


FULL = {"grid": None, "bayesian": 18, "genetic": 4}


@pytest.mark.parametrize("name", list(FULL))
def test_strategies_propose_and_write_what_vct_does(tmp_path, name):
    ends = {}
    for pkg in PACKAGES:
        root = tmp_path / pkg.name
        calls = []
        r = _stub_runner(pkg, root, calls)
        best, out = _captured(_sweep, name, pkg, r, FULL[name])
        ends[pkg.name] = (calls, best, out, _files(root))
    assert ends["port"] == ends["vct"]
    assert ends["port"][0] and ends["port"][3]


@pytest.mark.parametrize("name,cut", [("grid", 5), ("bayesian", 9), ("bayesian_legacy", 9),
                                      ("genetic", 2)])
def test_a_sweep_vct_interrupted_resumes_in_the_port_as_in_vct(tmp_path, name, cut):
    """vct runs the sweep to ``cut``; a copy of its directory resumes in vct
    and another in the port. The trial journal (and, for
    ``bayesian_legacy``, the legacy JSON list it migrates from) and the GA's
    checkpoint with its ``rng_state`` must carry the same sweep on."""
    first = tmp_path / "first"
    _captured(_sweep, name, VCT, _stub_runner(VCT, first, []), cut)
    if name == "bayesian_legacy":
        journal = first / "bayes_trials.json"
        trials = [json.loads(line) for line in journal.read_text().splitlines()]
        journal.write_text(json.dumps(trials))
    ends = {}
    for pkg in PACKAGES:
        root = tmp_path / pkg.name
        shutil.copytree(first, root)
        calls = []
        best, out = _captured(_sweep, name, pkg, _stub_runner(pkg, root, calls),
                              FULL[name.split("_")[0]])
        ends[pkg.name] = (calls, best, out, _files(root))
    assert ends["port"] == ends["vct"]
    assert ends["port"][0]  # the resumed part proposed configurations


# ---------------------------------------------------------------------------
# runner


def test_runner_threshold_seeds_failures_and_best_model_match_vct(tmp_path):
    """Four repeat runs, seeded ``train.seed + run_idx``: the second raises
    (logged, skipped), the others score 0.8, 0.5, 0.9 against the 0.71
    threshold; the best model directory is copied under the config's
    ``artifact_name``; then a config under the threshold records nothing."""
    ends = {}
    for pkg in PACKAGES:
        root = tmp_path / pkg.name
        (root / "model").mkdir(parents=True)
        (root / "model" / "weights.bin").write_bytes(b"trained")
        seeds = []

        class R(pkg.runner.SweepRunner):
            def _train_once(self, cfg):
                seeds.append(cfg.train.seed)
                if len(seeds) == 2:
                    raise RuntimeError("no metric block")
                return pkg.RunMetrics(f1=(0.8, 0.0, 0.5, 0.9, 0.6)[len(seeds) - 1])

        cfg = pkg.Config().replace(**{
            "sweep.checkpoint_file": str(root / "ckpt.json"),
            "sweep.best_model_dir": str(root / "best"), "sweep.f1_threshold": "0.71",
            "train.model_path": str(root / "model"), "train.seed": "5"})
        r = R(cfg, store=pkg.store.SweepStore(cfg.sweep.checkpoint_file), **pkg.device)
        first, out1 = _captured(r.run_training, {"model.rnn_type": "lstm"}, test_runs=4)
        second, out2 = _captured(r.run_training, {"model.rnn_type": "gru"}, test_runs=1)
        ends[pkg.name] = (seeds, first, second, out1, out2, _files(root), r.best_results)
    assert ends["port"] == ends["vct"]
    seeds, first, second = ends["port"][:3]
    assert seeds == [5, 6, 7, 8, 5] and first[0] == 0.9 and "rnnTypelstm" in first[1]
    assert second == (0.6, None)


def _recording(pkg, runs):
    """``pkg``'s SweepRunner that keeps each trial's RunMetrics."""
    class Recording(pkg.runner.SweepRunner):
        def _train_once(self, cfg):
            metrics = super()._train_once(cfg)
            runs.append(metrics)
            return metrics

    return Recording


def _real_cfg(pkg, root, **extra):
    return pkg.Config().replace(**{
        **SMALL, "train.feature_cache": "true", "train.epochs": "2",
        "train.weighted_loss": "true", "train.save_model": "true",
        "train.model_path": str(root / "trial_model"),
        "sweep.checkpoint_file": str(root / "ckpt.json"),
        "sweep.best_model_dir": str(root / "best"), "sweep.f1_threshold": "-1",
        "sweep.test_runs": "1", **extra})


def test_one_real_trial_matches_vct(tmp_path, monkeypatch):
    """One in-process LSTM trial (K2's path: Pallas in interpret mode in vct,
    the plain version here) through each runner, the port's from vct's
    initial variables: accuracy, precision, recall and F1 equal, epoch
    losses within 1e-5, the store entries equal but for the durations, and
    the best model a checkpoint the port loads."""
    data = generate_dummy_data(num_samples=12, sequence_length=T_SEQ, height=HW, width=HW,
                               num_classes=CLASSES, seed=3)
    variables = {}
    vct_init = vct_engine.Trainer.init_state

    def keep_variables(self, rng, x):
        state = vct_init(self, rng, x)
        variables.update({"params": jax.device_get(state.params),
                          **jax.device_get(state.extra_vars)})
        return state

    port_init = engine.Trainer.init_state

    def from_vct_variables(self):
        load_vct_variables(self.model, variables)
        return port_init(self)

    monkeypatch.setattr(vct_engine.Trainer, "init_state", keep_variables)
    monkeypatch.setattr(engine.Trainer, "init_state", from_vct_variables)
    ends = {}
    for pkg in PACKAGES:
        root = tmp_path / pkg.name
        runs = []
        r = _recording(pkg, runs)(_real_cfg(pkg, root), data=data, **pkg.device)
        f1, name = r.run_training({"model.rnn_type": "lstm"})
        ends[pkg.name] = (runs, f1, name, r.store.load(), root)
    (want, *_), f1_v, name_v, entries_v, _ = ends["vct"]
    (got, *_), f1_t, name_t, entries_t, root = ends["port"]
    for key in ("accuracy", "precision", "recall", "f1"):
        assert getattr(got, key) == getattr(want, key), key
    assert len(got.epoch_losses) == len(want.epoch_losses) == 2
    np.testing.assert_allclose(got.epoch_losses, want.epoch_losses, atol=LOSS_ATOL, rtol=0)
    assert got.epoch_accs == want.epoch_accs
    assert (f1_t, name_t) == (f1_v, name_v)

    def timeless(entries):
        return [{**e, "metrics": {k: v for k, v in e["metrics"].items()
                                  if not k.endswith("_duration")}} for e in entries]

    assert timeless(entries_t) == timeless(entries_v) and len(entries_t) == 1
    state_dict, cfg, names, manifest = load_checkpoint(str(root / "best" / name_t))
    assert manifest["framework"] == "vct_torch" and names == data[2]
    assert cfg.model.rnn_type == "lstm" and "cnn_backbone.conv1.weight" in state_dict


def test_a_trial_after_another_equals_the_trial_alone(tmp_path):
    """No state leaks between trials of one runner: an LSTM trial (dropout
    0.25, its masks from the trainer's generator) after a Mamba trial gives
    the losses and metrics of the same trial in a fresh runner, bit for
    bit."""
    data = generate_dummy_data(num_samples=12, sequence_length=T_SEQ, height=HW, width=HW,
                               num_classes=CLASSES, seed=4)
    trial = {"model.rnn_type": "lstm", "model.dropout": 0.25, "train.learning_rate": 0.01}
    results = []
    for before in ([{"model.rnn_type": "mamba", "train.learning_rate": 0.03}], []):
        root = tmp_path / str(len(results))
        runs = []
        r = _recording(PORT, runs)(_real_cfg(PORT, root, **{"train.save_model": "false"}),
                                   data=data, device="cpu")
        for config in before + [trial]:
            _captured(r.run_training, config)
        results.append(runs[-1])
    after, alone = results
    assert after.epoch_losses == alone.epoch_losses and after.epoch_accs == alone.epoch_accs
    assert (after.accuracy, after.f1, after.per_class) == (alone.accuracy, alone.f1,
                                                          alone.per_class)


# ---------------------------------------------------------------------------
# streamed and subprocess trials, the card by default


def test_a_streamed_trial_trains_from_the_clip_cache_and_records(tmp_path):
    """tests/test_sweep.py's streamed trial in the port: out of core from a
    shared clip cache, recorded in the store."""
    cfg = Config().replace(**{
        "data.processed_data_path": str(tmp_path / "cache"), "data.cache_format": "clipcache",
        "data.stream": "true", "data.sequence_length": "3", "data.img_height": "8",
        "data.img_width": "8", "data.max_videos": "5", "model.cnn_backbone": "resnet18",
        "model.rnn_type": "gru", "model.rnn_input_size": "4", "model.rnn_layer": "1",
        "model.num_classes": "3", "train.batch_size": "4", "train.epochs": "1",
        "train.save_model": "false", "sweep.checkpoint_file": str(tmp_path / "sweep.json"),
        "sweep.f1_threshold": "-1"})
    (tmp_path / "cache").mkdir()
    rng = np.random.RandomState(0)
    write_clipcache(cfg.data.data_file, rng.randint(0, 256, (12, 3, 8, 8, 3), np.uint8),
                    rng.randint(0, 3, 12).astype(np.int64))
    np.save(cfg.data.classes_file, np.asarray(["a", "b", "c"]))
    runs = []
    r = _recording(PORT, runs)(cfg, store=store.SweepStore(cfg.sweep.checkpoint_file),
                               device="cpu")
    (f1, _), out = _captured(r.run_training, {"model.rnn_type": "gru"}, test_runs=1)
    assert "streaming from" in out and len(runs) == 1 and len(runs[0].epoch_losses) == 1
    assert f1 == runs[0].f1 and r.store.load()[0]["metrics"] == runs[0].to_dict()


def test_a_subprocess_trial_scrapes_what_the_child_printed(tmp_path):
    """``python -m vct_torch.train --device cpu`` as a child: the metrics
    the runner records are the ones the child printed, and the sweep log
    holds its output."""
    cfg = Config().replace(**{
        **SMALL, "data.synthetic": "true", "data.synthetic_samples": "8",
        "train.epochs": "1", "train.model_path": str(tmp_path / "model"),
        "sweep.log_file": str(tmp_path / "sweep.log"),
        "sweep.checkpoint_file": str(tmp_path / "ckpt.json"),
        "sweep.best_model_dir": str(tmp_path / "best"), "sweep.f1_threshold": "-1"})
    runs = []
    r = _recording(PORT, runs)(cfg, use_subprocess=True, device="cpu")
    (f1, name), _ = _captured(r.run_training, {"model.rnn_type": "gru"}, test_runs=1)
    log = (tmp_path / "sweep.log").read_text()
    assert log.startswith("Train: (6, 4, 32, 32, 3)") and "Epoch 1/1" in log
    assert dataclasses.asdict(runs[0]) == dataclasses.asdict(extract_metrics(log))
    assert r.store.load()[0]["metrics"] == runs[0].to_dict() and f1 == runs[0].f1
    assert (tmp_path / "best" / name / "weights.pt").exists()


def _space_file(tmp_path, points):
    path = tmp_path / "space.json"
    path.write_text(json.dumps({"model.rnn_type": points}))
    return str(path)


def test_the_runner_and_the_cli_need_the_card_by_default(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = Config().replace(**{"sweep.checkpoint_file": str(tmp_path / "ckpt.json")})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        runner.SweepRunner(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["--space", _space_file(tmp_path, ["gru"]),
                  "--sweep.checkpoint_file", str(tmp_path / "ckpt.json")])
    assert not (tmp_path / "ckpt.json").exists()


# ---------------------------------------------------------------------------
# python -m vct_torch.sweep


def test_the_cli_records_the_configurations_vct_records(tmp_path, monkeypatch):
    """A two-point grid on synthetic data: the port trains both on the CPU;
    vct's ``main`` on the same argv (its trials stubbed: a real vct trial is
    held above) records the same configurations in the same order, and both
    print the same trial lines."""
    monkeypatch.setattr(vct.utils.compilecache, "enable_persistent_compile_cache", lambda: None)
    monkeypatch.setattr(vct_runner.SweepRunner, "_train_once",
                        lambda self, cfg: VctRunMetrics(f1=0.5))
    space_path = _space_file(tmp_path, ["lstm", "gru"])
    ends = {}
    for pkg, main, extra in ((VCT, vct_cli.main, []), (PORT, cli.main, ["--device", "cpu"])):
        root = tmp_path / pkg.name
        argv = ["--strategy", "grid", "--space", space_path, *extra,
                *[a for k, v in SMALL.items() for a in (f"--{k}", v)],
                "--data.synthetic", "true", "--data.synthetic_samples", "8",
                "--train.epochs", "1", "--train.save_model", "false",
                "--sweep.checkpoint_file", str(root / "sweep.json"),
                "--sweep.test_runs", "1", "--sweep.f1_threshold", "-1"]
        rc, out = _captured(main, argv)
        lines = out.splitlines()
        ends[pkg.name] = (rc, [e["config"] for e in json.loads((root / "sweep.json").read_text())],
                          [lines[i + 1] for i, l in enumerate(lines) if l == "Applying config:"],
                          sorted(p.name for p in root.iterdir()),
                          any(l.startswith("Best result: {") for l in lines))
    assert ends["port"] == ends["vct"]
    assert ends["port"][1] == [{"model.rnn_type": "lstm"}, {"model.rnn_type": "gru"}]


@pytest.mark.parametrize("strategy,space_,knobs", [
    ("bayesian", TPE_SPACE, ["--sweep.n_trials", "12", "--train.seed", "5"]),
    ("genetic", GA_SPACE, ["--sweep.population", "4", "--sweep.generations", "3",
                           "--sweep.cx_prob", "0.9", "--sweep.mut_prob", "0.5",
                           "--train.seed", "5"]),
])
def test_the_cli_dispatches_each_strategy_as_vct_does(tmp_path, monkeypatch, strategy, space_,
                                                      knobs):
    """``--strategy bayesian`` and ``genetic`` take ``sweep.n_trials``,
    ``population``, ``generations``, ``cx_prob``, ``mut_prob`` and
    ``train.seed`` as vct's ``main`` does: on stub trials both print the
    same lines and leave the same files."""
    monkeypatch.setattr(vct.utils.compilecache, "enable_persistent_compile_cache", lambda: None)
    for pkg in PACKAGES:
        monkeypatch.setattr(pkg.runner.SweepRunner, "_train_once",
                            lambda self, cfg, pkg=pkg: pkg.RunMetrics(f1=_score(cfg)))
    space_path = tmp_path / "space.json"
    space_path.write_text(json.dumps(space_))
    ends = {}
    for pkg, main, extra in ((VCT, vct_cli.main, []), (PORT, cli.main, ["--device", "cpu"])):
        root = tmp_path / pkg.name
        argv = ["--strategy", strategy, "--space", str(space_path), *extra, *knobs,
                "--sweep.checkpoint_file", str(root / "ckpt.json"), "--sweep.test_runs", "1",
                "--sweep.f1_threshold", "0.5", "--train.model_path", str(root / "none")]
        ends[pkg.name] = (*_captured(main, argv), _files(root))
    assert ends["port"] == ends["vct"]
    rc, out, files = ends["port"]
    assert rc == 0 and out.count("Applying config:") == (12 if strategy == "bayesian" else 16)
    assert len(files) == 2  # the compacted store and the trial journal or GA checkpoint


def test_the_cli_returns_2_with_usage_as_vct_does(tmp_path, monkeypatch):
    monkeypatch.setattr(vct.utils.compilecache, "enable_persistent_compile_cache", lambda: None)
    space_path = _space_file(tmp_path, ["gru"])
    unknown = ["--strategy", "random", "--space", space_path,
               "--sweep.checkpoint_file", str(tmp_path / "ckpt.json")]
    for argv in ([], ["--config", "cfg.json"], unknown):
        want = _captured(vct_cli.main, list(argv))
        got = _captured(cli.main, ["--device", "cpu", *argv])
        assert got[0] == want[0] == 2
        if argv is unknown:
            assert got[1] == want[1] == ("Unknown strategy: random. Available: "
                                         "['bayesian', 'genetic', 'grid']\n")
        else:
            assert got[1] == want[1].replace("vct.sweep", "vct_torch.sweep").replace(
                "[--a.b v", "[--device cpu] [--a.b v")
