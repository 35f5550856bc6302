"""K2's backward and its f32 plain version at H = 1, each against the plain
version in float64, over 1000 draws of the output gradient: the numbers
behind ``_check_rnn_backward``'s hold of dw_hh in tests/test_torch_cuda.py.

    PYTHONPATH=. python tests/torch_rnn_bwd_rounding.py

Needs the card (K2 runs there). The weights are ``_rnn_args``'s at
(B, T, H, L) = (3, 20, 1, 3); the draws come from one CUDA generator seeded
0, as ``_gen`` seeds it. For dw_hh it prints a JSON line for every draw where
some pair lies beyond BWD_RTOL of the largest magnitude: the kernel against
the f32 plain version (``k_r``), each against float64 (``k_f``, ``r_f``), as
multiples of that limit, and the draw as f32 hexadecimal values. A last line
counts those draws, gives each side's largest error over the sum of its
terms' magnitudes in units of f32's roundoff (the bound is B·T = 60), and
counts the draws that miss the test's hold.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))


def main() -> None:
    from test_torch_cuda import BWD_RTOL, F32_UNIT, _dw_hh_terms, _gen, _rnn_args
    from vct_torch.ops import _build
    from vct_torch.ops import lstm as ops

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    B, T, H, L = 3, 20, 1, 3
    args = _rnn_args(4, B, T, H, L, dev)
    args64 = [a.double() for a in args]
    gen = _gen(dev)
    beyond = {"k_r": 0, "k_f": 0, "r_f": 0}
    worst = {"k_r": 0.0, "k_f": 0.0, "r_f": 0.0, "kernel_units": 0.0, "plain_units": 0.0}
    missed_hold = 0
    for i in range(1000):
        gy = torch.randn((B, T, H), device=dev, generator=gen)
        _build.fill_shared_memory(float("nan"))
        leaves = [a.clone().requires_grad_(True) for a in args]
        kernel = torch.autograd.grad(ops.lstm_stack(*leaves), leaves, gy)[1].double()
        plain = ops.stack_bwd_ref(*args, gy)[1].double()
        exact = ops.stack_bwd_ref(*args64, gy.double())[1]
        terms = _dw_hh_terms(args, gy)
        limit = BWD_RTOL * exact.abs().max().item()
        row = {"k_r": (kernel - plain).abs().max().item() / (BWD_RTOL * plain.abs().max().item()),
               "k_f": (kernel - exact).abs().max().item() / limit,
               "r_f": (plain - exact).abs().max().item() / limit}
        hold = (B * T * F32_UNIT * terms).clamp(min=limit)
        missed_hold += bool(((kernel - exact).abs() > hold).any() or
                            ((plain - exact).abs() > hold).any())
        for k, v in row.items():
            worst[k] = max(worst[k], v)
            beyond[k] += v > 1.0
        for k, side in (("kernel_units", kernel), ("plain_units", plain)):
            worst[k] = max(worst[k], ((side - exact).abs() / terms).max().item() / F32_UNIT)
        if max(row.values()) > 1.0:
            print(json.dumps({"draw": i, **row,
                              "gy": [float.hex(v) for v in gy.flatten().tolist()]}), flush=True)
    print(json.dumps({"shape": [B, T, H, L], "draws": 1000, "beyond_limit": beyond,
                      "largest": worst, "terms_a_sum": B * T, "missed_hold": missed_hold,
                      "gpu": torch.cuda.get_device_name(0)}))


if __name__ == "__main__":
    main()
