"""Hyperparameter sweeps on the card: the port of ``vct/sweep``.

``SweepRunner`` trains each trial through the port's ``Trainer``; the space,
the store and the grid / TPE / genetic strategies are copies of ``vct``'s and
write the same files. ``python -m vct_torch.sweep`` is the entry point."""

from vct_torch.sweep.runner import SweepRunner  # noqa: F401
from vct_torch.sweep.space import normalize_space  # noqa: F401
from vct_torch.sweep.store import SweepStore, is_config_duplicate  # noqa: F401
from vct_torch.sweep.strategies import (  # noqa: F401
    STRATEGIES,
    bayesian_optimization,
    genetic_algorithm,
    grid_search,
)
