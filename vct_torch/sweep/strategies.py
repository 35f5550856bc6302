"""HPO strategies: grid, Bayesian (TPE-style), genetic. The port's copy of
``vct/sweep/strategies.py``: given the same objective values each strategy
proposes the same configurations and writes the same journal and checkpoint
files as ``vct``'s.

The reference uses itertools-product grid (``hyperparam.py:31-41``), Optuna
for Bayesian (``hyperparam.py:74-106``), and DEAP for genetic
(``hyperparam.py:150-223``). Neither optuna nor deap is a dependency here;
both strategies are implemented natively with the same resume semantics:

  * grid — completed-config skip from the JSON store (``hyperparam.py:32-38``)
  * bayesian — a TPE-style sampler (random warmup, then candidates drawn
    around the good quantile and ranked by good/bad density ratio), trials
    journaled to JSON (replacing the optuna sqlite study,
    ``hyperparam.py:95-101``)
  * genetic — two-point crossover, uniform re-draw mutation, tournament-3
    selection, hall-of-fame, per-generation JSON checkpoint resume
    (mirroring the DEAP toolbox setup at ``hyperparam.py:150-223``)
"""

from __future__ import annotations

import json
import math
import os
import random
from typing import Dict, List, Optional

from vct_torch.sweep.runner import SweepRunner
from vct_torch.sweep.space import SpaceDim, grid_points, normalize_space, sample_point
from vct_torch.sweep.store import is_config_duplicate

__all__ = ["grid_search", "bayesian_optimization", "genetic_algorithm", "STRATEGIES"]


def grid_search(runner: SweepRunner, space: Dict, max_trials: Optional[int] = None):
    dims = normalize_space(space)
    completed = runner.store.completed_configs()
    n = 0
    for config in grid_points(dims):
        if is_config_duplicate(completed, config):
            print(f"Skipping completed config: {config}")
            continue
        if max_trials is not None and n >= max_trials:
            break
        runner.run_training(config)
        completed.append(config)
        n += 1
    return runner.store.best()


# ----------------------------------------------------------------------
# TPE-style Bayesian optimization


class _Trials:
    """Journaled trial history (the optuna-sqlite resume analogue).

    Appends are one JSON line each — O(1), not a full-list rewrite per trial
    (at the reference's 664-entry sweep scale that rewrite is O(n^2) bytes).
    Loading sniffs the format: a legacy ``[``-prefixed JSON list still reads,
    and its first new append migrates the file to JSONL."""

    def __init__(self, path: str):
        self.path = path
        self.trials: List[dict] = []
        self._legacy = False
        if path and os.path.exists(path):
            with open(path) as f:
                head = f.read(1)
                f.seek(0)
                if head == "[":
                    self.trials = json.load(f)
                    self._legacy = True
                else:
                    for line in f:
                        if not line.strip():
                            continue
                        try:
                            self.trials.append(json.loads(line))
                        except json.JSONDecodeError:
                            # torn tail (crash mid-append): keep everything
                            # before it — resume must survive the very crash
                            # the journal exists for (mirrors
                            # SweepStore._load_journal). Route the next
                            # append through the full rewrite so it can't
                            # concatenate onto the torn line.
                            print("Skipping corrupt trial-journal line.")
                            self._legacy = True

    def append(self, config: dict, value: float):
        entry = {"config": config, "value": value}
        self.trials.append(entry)
        if not self.path:
            return
        os.makedirs(os.path.dirname(os.path.abspath(self.path)), exist_ok=True)
        if self._legacy:
            # one-time migration: rewrite the legacy JSON list as JSONL
            with open(self.path, "w") as f:
                for t in self.trials:
                    f.write(json.dumps(t) + "\n")
            self._legacy = False
            return
        with open(self.path, "a") as f:
            f.write(json.dumps(entry) + "\n")


def _dim_logpdf(dim: SpaceDim, value, observations: List) -> float:
    """Parzen-style log density of ``value`` under the observation set."""
    if not observations:
        return 0.0
    if dim.kind == "categorical":
        counts = sum(1 for o in observations if o == value) + 1.0
        return math.log(counts / (len(observations) + len(dim.choices)))
    vals = [float(o) for o in observations]
    lo, hi = float(dim.low), float(dim.high)
    if dim.kind == "float" and dim.log:
        vals = [math.log(v) for v in vals]
        value = math.log(value)
        lo, hi = math.log(lo), math.log(hi)
    span = max(hi - lo, 1e-12)
    bw = max(span / max(len(vals), 1) ** 0.5, span * 0.05)
    dens = sum(
        math.exp(-0.5 * ((value - v) / bw) ** 2) / (bw * math.sqrt(2 * math.pi))
        for v in vals
    ) / len(vals)
    return math.log(max(dens, 1e-300))


def bayesian_optimization(
    runner: SweepRunner,
    space: Dict,
    n_trials: int = 50,
    n_warmup: int = 10,
    gamma: float = 0.25,
    n_candidates: int = 24,
    seed: int = 0,
    trials_path: Optional[str] = None,
):
    dims = normalize_space(space)
    rng = random.Random(seed)
    trials = _Trials(
        trials_path
        or os.path.join(
            os.path.dirname(runner.store.path) or ".", "bayes_trials.json"
        )
    )

    while len(trials.trials) < n_trials:
        history = trials.trials
        if len(history) < n_warmup:
            config = sample_point(dims, rng)
        else:
            ranked = sorted(history, key=lambda t: -t["value"])
            n_good = max(1, int(gamma * len(ranked)))
            good, bad = ranked[:n_good], ranked[n_good:]
            best_cand, best_score = None, -float("inf")
            for _ in range(n_candidates):
                # Draw each dim from a good-trial's value jittered by the
                # Parzen kernel (mutate for categoricals), score by l(x)/g(x).
                base = rng.choice(good)["config"]
                cand = {}
                for d in dims:
                    if rng.random() < 0.7:
                        cand[d.key] = base.get(d.key, d.sample(rng))
                        if d.kind != "categorical" and rng.random() < 0.5:
                            cand[d.key] = d.sample(rng)
                    else:
                        cand[d.key] = d.sample(rng)
                score = sum(
                    _dim_logpdf(d, cand[d.key], [t["config"][d.key] for t in good])
                    - _dim_logpdf(d, cand[d.key], [t["config"][d.key] for t in bad])
                    for d in dims
                )
                if score > best_score:
                    best_cand, best_score = cand, score
            config = best_cand
        value = runner.objective(config)
        trials.append(config, value)
        print(f"trial {len(trials.trials)}/{n_trials}: f1={value:.4f} {config}")
    return runner.store.best()


# ----------------------------------------------------------------------
# Genetic algorithm (DEAP-style)


def genetic_algorithm(
    runner: SweepRunner,
    space: Dict,
    population_size: int = 10,
    generations: int = 5,
    cx_prob: float = 0.7,
    mut_prob: float = 0.2,
    tournament: int = 3,
    seed: int = 0,
    checkpoint_path: Optional[str] = None,
):
    dims = normalize_space(space)
    keys = [d.key for d in dims]
    rng = random.Random(seed)
    ckpt_path = checkpoint_path or os.path.join(
        os.path.dirname(runner.store.path) or ".", "genetic_checkpoint.json"
    )

    def evaluate(ind: List) -> float:
        return runner.objective(dict(zip(keys, ind)))

    # per-generation resume (hyperparam.py:186-221 pickle analogue)
    start_gen, population, fitnesses, hof = 0, None, None, None
    if os.path.exists(ckpt_path):
        with open(ckpt_path) as f:
            saved = json.load(f)
        start_gen = saved["generation"] + 1
        population = saved["population"]
        fitnesses = saved["fitnesses"]
        hof = saved.get("hall_of_fame")
        rng.setstate(tuple(
            tuple(x) if isinstance(x, list) else x for x in saved["rng_state"]
        ))
        print(f"Resuming GA from generation {start_gen}")

    if population is None:
        population = [[d.sample(rng) for d in dims] for _ in range(population_size)]
        fitnesses = [evaluate(ind) for ind in population]
        # The initial population competes for the hall of fame too — its best
        # individual may never survive selection.
        best_i = max(range(len(population)), key=lambda i: fitnesses[i])
        hof = {"individual": list(population[best_i]),
               "fitness": fitnesses[best_i]}

    for gen in range(start_gen, generations):
        # tournament-3 selection
        def select():
            contenders = rng.sample(range(len(population)), min(tournament, len(population)))
            return list(population[max(contenders, key=lambda i: fitnesses[i])])

        offspring = [select() for _ in range(population_size)]
        # two-point crossover
        for i in range(0, population_size - 1, 2):
            if rng.random() < cx_prob and len(dims) >= 2:
                a, b = sorted(rng.sample(range(len(dims)), 2))
                (offspring[i][a : b + 1], offspring[i + 1][a : b + 1]) = (
                    offspring[i + 1][a : b + 1],
                    offspring[i][a : b + 1],
                )
        # uniform mutation
        for ind in offspring:
            for j, d in enumerate(dims):
                if rng.random() < mut_prob:
                    ind[j] = d.mutate(ind[j], rng)

        population = offspring
        fitnesses = [evaluate(ind) for ind in population]
        best_i = max(range(len(population)), key=lambda i: fitnesses[i])
        if hof is None or fitnesses[best_i] > hof["fitness"]:
            hof = {"individual": population[best_i], "fitness": fitnesses[best_i]}
        print(f"generation {gen}: best f1={max(fitnesses):.4f} hof={hof['fitness']:.4f}")

        os.makedirs(os.path.dirname(os.path.abspath(ckpt_path)), exist_ok=True)
        with open(ckpt_path, "w") as f:
            json.dump(
                {
                    "generation": gen,
                    "population": population,
                    "fitnesses": fitnesses,
                    "hall_of_fame": hof,
                    "rng_state": rng.getstate(),
                },
                f,
            )
    return runner.store.best()


STRATEGIES = {
    "grid": grid_search,
    "bayesian": bayesian_optimization,
    "genetic": genetic_algorithm,
}
