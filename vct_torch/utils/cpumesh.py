"""Environment recipe for the child processes of a gloo CPU world: the
counterpart of ``vct/utils/cpumesh.py``.

``vct`` provisions an n-device virtual CPU mesh in a scrubbed child process
through XLA flags (a forced host device count, longer collective
rendezvous). The port's CPU world is n processes, one rank each, joined by
gloo over localhost: there are no XLA flags to set. What the recipe keeps
is what makes n ranks on a few cores reliable:

* one thread per math library (``THREAD_CLAMPS``, copied from ``vct``):
  n ranks each running a full-width intra-op pool would oversubscribe the
  cores and stall the collectives' partners;
* ``CUDA_VISIBLE_DEVICES=""``: a CPU rank never touches a card;
* the repository on ``PYTHONPATH``, and ``MASTER_ADDR`` / ``MASTER_PORT``
  on a free localhost port, the variables ``torchrun`` would set.
"""

from __future__ import annotations

import socket
from typing import Dict, Mapping

__all__ = ["virtual_cpu_env", "THREAD_CLAMPS", "free_port"]

# One thread per math library: n ranks share the host's cores.
THREAD_CLAMPS = {
    "OMP_NUM_THREADS": "1",
    "OPENBLAS_NUM_THREADS": "1",
    "MKL_NUM_THREADS": "1",
    "NUMEXPR_NUM_THREADS": "1",
}


def free_port() -> int:
    """A localhost TCP port no one listens on right now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def virtual_cpu_env(base_env: Mapping[str, str], n_ranks: int, repo_root: str) -> Dict[str, str]:
    """A copy of ``base_env`` for the ranks of an ``n_ranks`` gloo CPU world
    (each rank adds its own ``RANK`` and ``LOCAL_RANK``)."""
    env = dict(base_env)
    env["PYTHONPATH"] = repo_root
    env["CUDA_VISIBLE_DEVICES"] = ""
    env["MASTER_ADDR"] = "127.0.0.1"
    env["MASTER_PORT"] = str(free_port())
    env["WORLD_SIZE"] = str(n_ranks)
    for key, val in THREAD_CLAMPS.items():
        env.setdefault(key, val)
    return env
