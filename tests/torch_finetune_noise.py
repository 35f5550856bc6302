"""How far f32 goes through a whole backbone, on the CPU: the numbers behind
the gradient tolerance of tests/test_torch_finetune.py.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/torch_finetune_noise.py [key=value ...]

A finetune LRCN as tests/test_torch_finetune.py builds it (the
``key=value`` pairs are its ``model.*`` overrides, e.g. ``rnn_type=lstm``),
one loss's gradients by the port (f32), by ``vct`` (f32) and by ``vct`` in
float64; for each parameter tensor, each f32 side's largest distance to the
float64 gradients and the two sides' distance to each other, over the
tensor's largest magnitude. The heads run ``scan_impl="scan"`` (vct's Pallas
ops take f32 only).
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))


def grads(overrides: dict) -> None:
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_default_matmul_precision", "float32")
    import test_torch_finetune as tf
    from test_torch_train import _in_port_layout, _vct_loss_shim

    vct_model, trainer, variables, x = tf._finetune_pair(**{"scan_impl": "scan", **overrides})
    y = np.array([1, 3], np.int64)
    stats = {k: v for k, v in variables.items() if k != "params"}
    shim = _vct_loss_shim("multiclass", None)

    def vct_grads(dtype):
        tree = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), variables)
        rest = {k: v for k, v in tree.items() if k != "params"}

        def loss_of(params):
            logits = vct_model.apply({"params": params, **rest}, jnp.asarray(x, dtype))
            return shim._loss_fn(logits, jnp.asarray(y), jnp.ones((len(y),), dtype))[0]

        _, g = jax.jit(jax.value_and_grad(loss_of))(tree["params"])
        return _in_port_layout(trainer.model, jax.tree_util.tree_map(np.asarray, g), stats)

    _, port = tf._port_gradients(trainer, x, y)
    theirs = vct_grads(jnp.float32)
    jax.config.update("jax_enable_x64", True)
    exact = {n: torch.as_tensor(np.asarray(v), dtype=torch.float64)
             for n, v in vct_grads(jnp.float64).items()}
    rows = []
    for name, g in port.items():
        if g is None:
            continue
        scale = exact[name].abs().max().item()
        rows.append((name, (g.double() - exact[name]).abs().max().item() / scale,
                     (theirs[name].double() - exact[name]).abs().max().item() / scale,
                     (g - theirs[name]).abs().max().item() / theirs[name].abs().max().item()))
    for name, port_err, vct_err, apart in sorted(rows, key=lambda r: -r[3])[:10]:
        print(f"{name:48s} port {port_err:.2e}  vct {vct_err:.2e}  apart {apart:.2e}")
    print(f"largest: port {max(r[1] for r in rows):.3e}, vct {max(r[2] for r in rows):.3e}, "
          f"apart {max(r[3] for r in rows):.3e}; tensors apart beyond 1e-5: "
          f"{sum(r[3] > 1e-5 for r in rows)} of {len(rows)}")


if __name__ == "__main__":
    grads(dict(a.split("=", 1) for a in sys.argv[1:]))
