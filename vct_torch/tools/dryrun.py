"""Multi-rank dryruns: the counterparts of ``vct``'s
``dryrun_multichip`` / ``dryrun_multihost`` (``__graft_entry__.py``).

    python -m vct_torch.tools.dryrun multichip N [--device cpu|cuda]
    python -m vct_torch.tools.dryrun multihost P [--device cpu|cuda]

``multichip N`` starts N ranks (one process each, ``torch.distributed``:
NCCL on the cards, gloo on the CPU) and takes one train step of ``vct``'s
dryrun config (resnet18, Mamba head, rnn_input 8, 2 layers, T = 4, 32x32,
a batch of N, ``model.seq_shard`` on, ``mesh.donate`` off) on a
(N/2, 2) mesh (N odd: (N, 1)); it prints ``dryrun_multichip ok:
mesh={...} loss=... acc=...``. ``multihost P`` starts P processes on a
(P, 1) mesh, each loading only its ``process_shard`` rows of the global
batch, takes one step, then saves a checkpoint that only the primary
writes; it prints ``dryrun_multihost ok: ...``.

On the CPU (``--device cpu``) the ranks are a gloo world on localhost with
one thread each (``vct_torch.utils.cpumesh``): the counterpart of ``vct``'s
virtual 8-device CPU mesh. On the cards rank ``r`` takes ``cuda:r``.
Each rank's output goes to a file; a rank that fails, or a world past
``WORLD_TIMEOUT_S``, fails the run, the others are stopped, and every
rank's last lines are printed.

``run_world`` is the launcher, for any script that runs as the ranks of a
world (the CPU tests and ``chip_smoke.py`` use it too).
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence

__all__ = ["run_world", "WorldFailed", "dryrun_multichip", "dryrun_multihost", "main"]

REPO_ROOT = str(Path(__file__).resolve().parents[2])
TAIL_LINES = 12
WORLD_TIMEOUT_S = 600


class WorldFailed(RuntimeError):
    """A rank of a world exited with an error, or the world timed out."""


def _world_env(n: int, device: str) -> Dict[str, str]:
    from vct_torch.utils.cpumesh import free_port, virtual_cpu_env

    if device == "cpu":
        return virtual_cpu_env(os.environ, n, REPO_ROOT)
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO_ROOT + (os.pathsep + env["PYTHONPATH"]
                                     if env.get("PYTHONPATH") else "")
    env["MASTER_ADDR"] = "127.0.0.1"
    env["MASTER_PORT"] = str(free_port())
    env["WORLD_SIZE"] = str(n)
    return env


def run_world(n: int, argv: Sequence[str], device: str = "cpu") -> List[str]:
    """Run ``python argv...`` as the ``n`` ranks of a world (``RANK``,
    ``LOCAL_RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT`` set, as
    ``torchrun`` sets them; ``device="cpu"`` scrubs the ranks onto the CPU).
    Returns each rank's output. A rank that exits non-zero, or a world past
    ``WORLD_TIMEOUT_S``, stops every rank and raises ``WorldFailed`` with
    each rank's last lines. Every process started is waited for."""
    env = _world_env(n, device)
    with tempfile.TemporaryDirectory(prefix="vct_world_") as tmp:
        logs = [open(Path(tmp) / f"rank{r}.log", "w+") for r in range(n)]
        procs = []
        try:
            for rank in range(n):
                procs.append(subprocess.Popen(
                    [sys.executable, *argv],
                    env={**env, "RANK": str(rank), "LOCAL_RANK": str(rank)},
                    stdout=logs[rank], stderr=subprocess.STDOUT, cwd=REPO_ROOT))
            deadline = time.monotonic() + WORLD_TIMEOUT_S
            failed = None
            while any(p.poll() is None for p in procs):
                bad = [r for r, p in enumerate(procs) if p.poll() not in (None, 0)]
                if bad or time.monotonic() > deadline:
                    failed = (f"rank {bad[0]} exited with {procs[bad[0]].returncode}" if bad
                              else f"the world passed its {WORLD_TIMEOUT_S} s")
                    break
                time.sleep(0.05)
            else:
                bad = [r for r, p in enumerate(procs) if p.returncode != 0]
                if bad:
                    failed = f"rank {bad[0]} exited with {procs[bad[0]].returncode}"
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            for p in procs:
                p.wait()
        outputs = []
        for log in logs:
            log.seek(0)
            outputs.append(log.read())
            log.close()
    if failed:
        tails = "\n".join(f"--- rank {r} (rc={p.returncode}):\n"
                          + "\n".join(out.splitlines()[-TAIL_LINES:])
                          for r, (p, out) in enumerate(zip(procs, outputs)))
        raise WorldFailed(f"{n}-rank world: {failed}\n{tails}")
    return outputs


# ---------------------------------------------------------------------------
# the ranks

def _dryrun_cfg(batch: int, **extra):
    from vct_torch.core.config import Config

    return Config().replace(**{
        "model.cnn_backbone": "resnet18",
        "model.rnn_type": "mamba",
        "model.rnn_input_size": "8",
        "model.rnn_layer": "2",
        "data.sequence_length": "4",
        "data.img_height": "32",
        "data.img_width": "32",
        "train.batch_size": str(batch),
        "mesh.donate": "false",
        **extra,
    })


def _rank_device(device: str):
    return "cpu" if device == "cpu" else None  # None: cuda:LOCAL_RANK


def _multichip_rank(n: int, device: str) -> None:
    import numpy as np

    from vct_torch.data.synthetic import generate_dummy_data
    from vct_torch.parallel import multihost
    from vct_torch.parallel.mesh import make_mesh
    from vct_torch.train.engine import Trainer

    multihost.initialize(device=_rank_device(device))
    # A rank that fails exits with its traceback; run_world stops the others.
    model_size = 2 if n % 2 == 0 and n >= 2 else 1
    mesh = make_mesh(data=n // model_size, model=model_size)
    cfg = _dryrun_cfg(n, **{"model.seq_shard": "true"})
    x, y, class_names = generate_dummy_data(
        num_samples=n, sequence_length=4, height=32, width=32,
        num_classes=cfg.model.num_classes)
    trainer = Trainer(cfg, class_names, mesh=mesh)
    state = trainer.init_state()
    loss, correct, total = trainer._train_step(
        state, *trainer._put_global(x, y, np.ones(n, np.float32)))
    loss = float(loss)
    if not np.isfinite(loss):
        raise AssertionError(f"non-finite loss: {loss}")
    if multihost.is_primary():
        print(f"dryrun_multichip ok: mesh={dict(mesh.shape)} loss={loss:.4f} "
              f"acc={float(correct) / max(float(total), 1):.3f}", flush=True)
    multihost.shutdown()


def _multihost_rank(n_processes: int, device: str, out: str) -> None:
    import numpy as np

    from vct_torch.data.synthetic import generate_dummy_data
    from vct_torch.parallel import multihost
    from vct_torch.parallel.mesh import make_mesh, shard_batch
    from vct_torch.train.checkpoint import gather_state_dict, save_checkpoint
    from vct_torch.train.engine import Trainer

    multihost.initialize(device=_rank_device(device))
    # A rank that fails exits with its traceback; run_world stops the others.
    rank = multihost.process_index()
    if multihost.process_count() != n_processes:
        raise AssertionError(f"world of {multihost.process_count()} != {n_processes}")
    mesh = make_mesh(data=n_processes, model=1)
    batch = 2 * n_processes
    cfg = _dryrun_cfg(batch)
    # Every rank draws the same global dataset and keeps only its rows:
    # the multi-process loading contract (process_shard).
    x, y, class_names = generate_dummy_data(
        num_samples=batch, sequence_length=4, height=32, width=32,
        num_classes=cfg.model.num_classes)
    local = multihost.process_shard(batch)
    if len(local) != batch // n_processes:
        raise AssertionError(f"rank {rank} holds {len(local)} rows")
    trainer = Trainer(cfg, class_names, mesh=mesh)
    state = trainer.init_state()
    # A rank mesh's shard_batch takes the rows as this process's own.
    batch_local = shard_batch((x[local], y[local], np.ones(len(local), np.float32)), mesh)
    loss, _, _ = trainer._train_step(state, *batch_local)
    loss = float(loss)  # summed over the ranks: the same on every one
    if not np.isfinite(loss):
        raise AssertionError(f"non-finite loss: {loss}")
    if multihost.is_primary() != (rank == 0):
        raise AssertionError("is_primary is not rank 0's alone")
    ckpt = os.path.join(out, "mh_ckpt")
    save_checkpoint(ckpt, gather_state_dict(state), cfg, class_names)
    if not os.path.exists(os.path.join(ckpt, "manifest.json")):
        raise AssertionError(f"rank {rank}: no checkpoint past the save's barrier")
    print(f"multihost rank {rank} ok: loss={loss:.4f}", flush=True)
    multihost.shutdown()


# ---------------------------------------------------------------------------
# the launchers

def _primary_line(outputs: List[str], prefix: str) -> str:
    for line in outputs[0].splitlines():
        if line.startswith(prefix):
            return line
    raise WorldFailed(f"rank 0 printed no {prefix!r} line:\n{outputs[0][-2000:]}")


def dryrun_multichip(n: int, device: str = "cpu") -> str:
    """One train step on a (n/2, 2) mesh of n ranks; returns rank 0's line."""
    args = ["-m", "vct_torch.tools.dryrun", "_multichip-rank", str(n), "--device", device]
    line = _primary_line(run_world(n, args, device), "dryrun_multichip ok:")
    print(line, flush=True)
    return line


def dryrun_multihost(n_processes: int = 2, device: str = "cpu") -> str:
    """P processes, each loading its rows, then a primary-gated checkpoint."""
    with tempfile.TemporaryDirectory(prefix="vct_multihost_") as tmp:
        outputs = run_world(n_processes, ["-m", "vct_torch.tools.dryrun", "_multihost-rank",
                                          str(n_processes), "--device", device, "--out", tmp],
                            device)
        if not os.path.exists(os.path.join(tmp, "mh_ckpt", "weights.pt")):
            raise WorldFailed("the primary wrote no checkpoint")
    losses = [_primary_line([out], f"multihost rank {r} ok:").split("loss=")[1]
              for r, out in enumerate(outputs)]
    if len(set(losses)) != 1:
        raise WorldFailed(f"the ranks' losses differ: {losses}")
    line = f"dryrun_multihost ok: {n_processes} processes x 1 rank, loss={losses[0]}"
    print(line, flush=True)
    return line


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("mode", choices=["multichip", "multihost", "_multichip-rank",
                                         "_multihost-rank"])
    parser.add_argument("n", type=int, help="ranks (multichip) or processes (multihost)")
    parser.add_argument("--device", default="cuda", choices=["cpu", "cuda"],
                        help="the ranks' device (default: the cards)")
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    if args.mode == "_multichip-rank":
        _multichip_rank(args.n, args.device)
    elif args.mode == "_multihost-rank":
        _multihost_rank(args.n, args.device, args.out)
    elif args.mode == "multichip":
        dryrun_multichip(args.n, args.device)
    else:
        dryrun_multihost(args.n, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
