"""The yardstick's counts: the card's peaks, the least work of each kernel
call from its shapes, and a model's operations a clip.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at the 700 W
limit): 3.35 TB/s of HBM, 67 TFLOP/s float32 outside the tensor cores (the
configurations state float32 with TF32 off). A kernel's least time is the
larger of its bytes (each input read once, each output written once) over
the memory rate and its operations over the float32 rate. The counts are frozen
copies of the arithmetic that ``chip_smoke.py`` prints its kernel bounds
with, and do not change when the program does.
"""

from __future__ import annotations

from bench_port.reference.model import RESNETS

__all__ = ["HBM_BYTES_PER_S", "F32_OPS_PER_S", "least_s", "k1_sad",
           "k3_forward", "rnn_stack_forward", "backbone_flops_per_frame",
           "head_flops_per_clip"]

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def least_s(work: tuple, ops_per_s: float = F32_OPS_PER_S) -> float:
    n_bytes, n_ops = work
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / ops_per_s)


def k1_sad(B: int, L: int, H: int, W: int, C: int) -> tuple:
    """K1, SAD scores of (B, L, H, W, C) uint8 clips: every frame read once,
    an f32 score a transition written; three integer operations (subtract,
    absolute value, add) a byte of each pair."""
    F = H * W * C
    return B * L * F + B * (L - 1) * 4, 3 * B * (L - 1) * F


def k3_forward(B: int, L: int, D: int, N: int) -> tuple:
    """K3, the selective scan: u, delta read and y written (B, L, D), B and
    C read (B, L, N), A (D, N); seven operations a (batch, step, channel,
    state): the exponent's product, the decay, the input term, the carry
    and the output's product and sum."""
    return 4 * (3 * B * L * D + 2 * B * L * N + D * N), 7 * B * L * D * N


def rnn_stack_forward(B: int, T: int, H: int, layers: int, gates: int) -> tuple:
    """K2, a stack of ``layers`` recurrent layers in one launch: layer 0's
    input projection read, the last layer's output written, the 2L - 1
    (H, gates H) matrices and their biases read; each of them applied at
    every step."""
    n_w = 2 * layers - 1
    GH = gates * H
    return 4 * (B * T * GH + B * T * H + n_w * (H + 1) * GH), 2 * B * T * n_w * H * GH


def _out(size: int, k: int, s: int, p: int) -> int:
    return (size + 2 * p - k) // s + 1


def backbone_flops_per_frame(cfg: dict) -> float:
    """Multiply-adds of a ResNet's convolutions at the configuration's
    frame size, two operations each (batch norm, activations, pooling
    not counted)."""
    kind, sizes = RESNETS[cfg["model"]["cnn_backbone"]]
    h, w = cfg["frame"][0], cfg["frame"][1]
    h, w = _out(h, 7, 2, 3), _out(w, 7, 2, 3)
    flops = 2 * 3 * 64 * 49 * h * w
    h, w = _out(h, 3, 2, 1), _out(w, 3, 2, 1)
    cin = 64
    expansion = 4 if kind == "bottleneck" else 1
    for stage, (width, n) in enumerate(zip((64, 128, 256, 512), sizes)):
        for i in range(n):
            s = 2 if stage > 0 and i == 0 else 1
            ho, wo = _out(h, 3, s, 1), _out(w, 3, s, 1)
            if kind == "bottleneck":
                flops += 2 * (cin * width * h * w + width * width * 9 * ho * wo
                              + width * 4 * width * ho * wo)
            else:
                flops += 2 * (cin * width * 9 * ho * wo + width * width * 9 * ho * wo)
            if s != 1 or cin != width * expansion:
                flops += 2 * cin * width * expansion * ho * wo
            h, w, cin = ho, wo, width * expansion
    return float(flops)


def head_flops_per_clip(cfg: dict) -> float:
    """The forward of the adapter, the temporal head and the classifier for
    one clip: every product's multiply-adds, two operations each, and the
    scan's state updates."""
    m = cfg["model"]
    T = int(cfg["sequence_length"])
    f = 2048 if RESNETS[m["cnn_backbone"]][0] == "bottleneck" else 512
    d = int(m["rnn_input_size"])
    hidden = int(m["hidden_size"]) if m.get("hidden_size") is not None \
        else int(m.get("mult_factor", 4)) * d
    layers = int(m["rnn_layer"])
    flops = 2 * T * (f * f // 2 + f // 2 * f // 4 + f // 4 * d)
    if m["rnn_type"] == "mamba":
        di, n = 2 * d, hidden
        per_step = (d * 2 * di + 3 * di + di * 3 * n + n * di + di * d) * 2 + 7 * di * n
        flops += T * layers * per_step
        width = d
    else:
        gates = 4 if m["rnn_type"] == "lstm" else 3
        for layer in range(layers):
            inp = d if layer == 0 else hidden
            flops += 2 * T * (inp + hidden) * gates * hidden
        width = hidden
    pooled = width * (T if m.get("rnn_out", "all") == "all" else 1)
    flops += 2 * (pooled * pooled // 2 + pooled // 2 * pooled // 4
                  + pooled // 4 * int(m["num_classes"]))
    return float(flops)

