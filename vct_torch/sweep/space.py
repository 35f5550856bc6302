"""Search-space definition shared by all sweep strategies: the port's copy of
``vct/sweep/space.py`` (plain Python; the same seed and space draw the same
points in the same order).

A space maps dotted config keys (``model.rnn_type`` ...) to either a list of
choices (grid/genetic style, like the reference's CONFIG dict of lists in
``automation.py:20-40``) or a distribution dict (Bayesian style, like the
optuna suggest_* calls in ``hyperparam.py:44-60``):

    {"train.learning_rate": {"type": "float", "low": 1e-5, "high": 1e-2, "log": true},
     "model.hidden_size":   {"type": "int", "low": 8, "high": 64},
     "model.rnn_type":      ["lstm", "gru", "mamba"]}
"""

from __future__ import annotations

import itertools
import math
import random
from typing import Any, Dict, Iterator, List

__all__ = ["normalize_space", "grid_points", "sample_point", "SpaceDim"]


class SpaceDim:
    def __init__(self, key: str, spec: Any):
        self.key = key
        if isinstance(spec, (list, tuple)):
            self.kind = "categorical"
            self.choices = list(spec)
        elif isinstance(spec, dict):
            self.kind = spec["type"]
            if self.kind == "categorical":
                self.choices = list(spec["choices"])
            else:
                self.low = spec["low"]
                self.high = spec["high"]
                self.log = bool(spec.get("log", False))
                self.step = spec.get("step")
        else:
            raise ValueError(f"Bad space spec for {key}: {spec!r}")

    def sample(self, rng: random.Random):
        if self.kind == "categorical":
            return rng.choice(self.choices)
        if self.kind == "int":
            if self.step:
                n = (self.high - self.low) // self.step
                return self.low + rng.randint(0, n) * self.step
            return rng.randint(self.low, self.high)
        if self.kind == "float":
            if self.log:
                return math.exp(rng.uniform(math.log(self.low), math.log(self.high)))
            return rng.uniform(self.low, self.high)
        raise ValueError(self.kind)

    def grid_values(self) -> List[Any]:
        if self.kind == "categorical":
            return self.choices
        if self.kind == "int":
            step = self.step or max(1, (self.high - self.low) // 4)
            return list(range(self.low, self.high + 1, step))
        raise ValueError(
            f"Grid search needs finite choices for {self.key} (kind={self.kind})"
        )

    def mutate(self, value, rng: random.Random):
        """Uniform re-draw (DEAP mutUniformInt analogue, hyperparam.py:166)."""
        return self.sample(rng)


def normalize_space(space: Dict[str, Any]) -> List[SpaceDim]:
    return [SpaceDim(k, v) for k, v in space.items()]


def grid_points(dims: List[SpaceDim]) -> Iterator[dict]:
    """itertools.product over all dims (automation.py:170-178 loop)."""
    keys = [d.key for d in dims]
    for combo in itertools.product(*(d.grid_values() for d in dims)):
        yield dict(zip(keys, combo))


def sample_point(dims: List[SpaceDim], rng: random.Random) -> dict:
    return {d.key: d.sample(rng) for d in dims}
