"""K2 and K5: the LSTM / GRU recurrences, forward.

Port of ``vct/ops/lstm_pallas.py``:

* K5 ``lstm_scan`` / ``gru_scan`` (the TPU kernels ``_lstm_kernel`` /
  ``_gru_kernel``): one layer, one direction, from the precomputed input
  projection ``xp = x @ W_ih + b_ih``;
* K2 ``lstm_stack`` / ``gru_stack`` (``_lstm_stack_kernel`` /
  ``_gru_stack_kernel``): a whole unidirectional stack of ``L >= 2`` layers
  in one launch, the inter-layer projections ``y @ W_ih[l+1] + b_ih[l+1]``
  included.

All four launch ``vct_torch/csrc/lstm.cu`` (K5 is its ``L = 1`` case); its
note says what bounds it on the H100 (the chain of ``T * L`` dependent
steps) and how its two designs meet that: "registers" for ``H <= 64``,
"columns" above. ``design`` says which one a shape takes. Weights keep
``vct``'s ``(in, G*H)`` layout; gate orders are torch's, [i, f, g, o] and
[r, z, n], with GRU's ``n = tanh(x_n + r * (h @ W_hn + b_hn))``. Forward
only: the backward comes with the training slice.

Each wrapper dispatches by device: a CPU tensor goes to the plain PyTorch
version (``lstm_scan_ref``, ``gru_scan_ref``, ``stack_ref``: loops over
time), a CUDA tensor to the kernel, which runs or the wrapper raises.
"""

from __future__ import annotations

import torch

from vct_torch.ops import _build

__all__ = [
    "lstm_scan", "gru_scan", "lstm_stack", "gru_stack",
    "lstm_scan_ref", "gru_scan_ref", "stack_ref", "design",
]

DESIGNS = ("columns", "registers")


def design(T: int, H: int, L: int, n_gates: int) -> str:
    """The kernel design a CUDA launch takes for these shapes, as the
    kernel library decides it (``vct_rnn_plan``); needs the built library."""
    return DESIGNS[_build.load_kernels().vct_rnn_plan(T, H, L, n_gates)]


def _check_layer(name, n_gates, xp, w_hh, b_hh) -> None:
    if xp.dim() != 3 or w_hh.dim() != 2:
        raise ValueError(
            f"{name} wants xp (B, T, G*H) and w_hh (H, G*H), got "
            f"{tuple(xp.shape)} and {tuple(w_hh.shape)}"
        )
    H = w_hh.shape[0]
    GH = n_gates * H
    if tuple(w_hh.shape) != (H, GH) or xp.shape[2] != GH or tuple(b_hh.shape) != (GH,):
        raise ValueError(
            f"{name} wants xp (B, T, {n_gates}H), w_hh (H, {n_gates}H), b_hh "
            f"({n_gates}H,), got {tuple(xp.shape)}, {tuple(w_hh.shape)}, {tuple(b_hh.shape)}"
        )


def _stack_gates(xp0, w_hh, b_hh, w_ih, b_ih) -> int:
    """Validate a stack's shapes; return its number of gates (4 or 3)."""
    if w_hh.dim() != 3 or w_hh.shape[1] == 0 or w_hh.shape[2] % w_hh.shape[1]:
        raise ValueError(f"stack wants w_hh (L, H, G*H), got {tuple(w_hh.shape)}")
    L, H, GH = w_hh.shape
    if L < 2:
        raise ValueError("stack op needs num_layers >= 2; use the "
                         "single-layer op for one layer")
    n_gates = GH // H
    if n_gates not in (3, 4):
        raise ValueError(f"stack wants G*H with G 4 (LSTM) or 3 (GRU), got {GH} for H={H}")
    if xp0.dim() != 3 or xp0.shape[2] != GH:
        raise ValueError(f"stack wants xp0 (B, T, {GH}), got {tuple(xp0.shape)}")
    for name, t, shape in (("b_hh", b_hh, (L, GH)), ("w_ih", w_ih, (L - 1, H, GH)),
                           ("b_ih", b_ih, (L - 1, GH))):
        if tuple(t.shape) != shape:
            raise ValueError(f"stack wants {name} of shape {shape}, got {tuple(t.shape)}")
    return n_gates


def lstm_scan_ref(xp, w_hh, b_hh) -> torch.Tensor:
    """Plain PyTorch version of K5 for the LSTM: xp (B, T, 4H), w_hh
    (H, 4H), b_hh (4H,) -> (B, T, H), from h = c = 0."""
    _check_layer("lstm_scan", 4, xp, w_hh, b_hh)
    B, T, _ = xp.shape
    h = xp.new_zeros(B, w_hh.shape[0])
    c = torch.zeros_like(h)
    ys = []
    for t in range(T):
        i, f, g, o = (xp[:, t] + h @ w_hh + b_hh).chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        ys.append(h)
    return torch.stack(ys, dim=1) if ys else xp.new_zeros(B, 0, w_hh.shape[0])


def gru_scan_ref(xp, w_hh, b_hh) -> torch.Tensor:
    """Plain PyTorch version of K5 for the GRU: xp (B, T, 3H), w_hh
    (H, 3H), b_hh (3H,) -> (B, T, H), from h = 0."""
    _check_layer("gru_scan", 3, xp, w_hh, b_hh)
    B, T, _ = xp.shape
    h = xp.new_zeros(B, w_hh.shape[0])
    ys = []
    for t in range(T):
        xr, xz, xn = xp[:, t].chunk(3, dim=-1)
        hr, hz, hn = (h @ w_hh + b_hh).chunk(3, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        h = (1.0 - z) * n + z * h
        ys.append(h)
    return torch.stack(ys, dim=1) if ys else xp.new_zeros(B, 0, w_hh.shape[0])


def stack_ref(xp0, w_hh, b_hh, w_ih, b_ih) -> torch.Tensor:
    """Plain PyTorch version of K2, layer by layer: xp0 (B, T, G*H), w_hh
    (L, H, G*H), b_hh (L, G*H), w_ih (L-1, H, G*H), b_ih (L-1, G*H) ->
    (B, T, H). G (4: LSTM, 3: GRU) follows from the shapes."""
    layer = lstm_scan_ref if _stack_gates(xp0, w_hh, b_hh, w_ih, b_ih) == 4 else gru_scan_ref
    buf = xp0
    for l in range(w_hh.shape[0]):
        buf = layer(buf, w_hh[l], b_hh[l])
        if l < w_hh.shape[0] - 1:
            buf = buf @ w_ih[l] + b_ih[l]
    return buf


def _launch(name, n_gates, xp, w_hh, b_hh, w_ih=None, b_ih=None):
    """Run the kernel on CUDA tensors; return (y, number of launches)."""
    if xp.device.type != "cuda":
        raise RuntimeError(f"{name}: no kernel for device {xp.device}")
    tensors = {"xp": xp, "w_hh": w_hh, "b_hh": b_hh, "w_ih": w_ih, "b_ih": b_ih}
    for tname, t in tensors.items():
        if t is None:
            continue
        if t.device != xp.device:
            raise ValueError(f"{name}: {tname} is on {t.device}, xp on {xp.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"the {name} kernel takes f32, {tname} is {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"the {name} kernel takes contiguous tensors, {tname} is not")
    B, T, GH = xp.shape
    H = GH // n_gates
    L = 1 if w_hh.dim() == 2 else w_hh.shape[0]
    y = torch.empty((B, T, H), dtype=torch.float32, device=xp.device)
    if y.numel() == 0:
        return y, 0
    lib = _build.load_kernels()
    with torch.cuda.device(xp.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.vct_rnn_fwd(
            xp.data_ptr(), w_hh.data_ptr(), b_hh.data_ptr(),
            None if w_ih is None else w_ih.data_ptr(),
            None if b_ih is None else b_ih.data_ptr(),
            y.data_ptr(), B, T, H, L, n_gates, stream,
        )
    _build.check(lib, err, f"{name} kernel launch")
    return y, 1


def lstm_scan(xp, w_hh, b_hh) -> torch.Tensor:
    """K5, LSTM: one layer from ``xp = x @ W_ih + b_ih``; (B, T, H) f32."""
    _check_layer("lstm_scan", 4, xp, w_hh, b_hh)
    if xp.device.type == "cpu":
        return lstm_scan_ref(xp, w_hh, b_hh)
    y, n = _launch("lstm_scan", 4, xp, w_hh, b_hh)
    lstm_scan.launches += n
    return y


def gru_scan(xp, w_hh, b_hh) -> torch.Tensor:
    """K5, GRU: one layer from ``xp = x @ W_ih + b_ih``; (B, T, H) f32."""
    _check_layer("gru_scan", 3, xp, w_hh, b_hh)
    if xp.device.type == "cpu":
        return gru_scan_ref(xp, w_hh, b_hh)
    y, n = _launch("gru_scan", 3, xp, w_hh, b_hh)
    gru_scan.launches += n
    return y


def lstm_stack(xp0, w_hh, b_hh, w_ih, b_ih) -> torch.Tensor:
    """K2, LSTM: the whole unidirectional stack (``L >= 2``) in one launch
    from layer 0's ``xp0 = x @ W_ih0 + b_ih0``; (B, T, H) f32."""
    if _stack_gates(xp0, w_hh, b_hh, w_ih, b_ih) != 4:
        raise ValueError(f"lstm_stack wants 4H gate columns, got w_hh {tuple(w_hh.shape)}")
    if xp0.device.type == "cpu":
        return stack_ref(xp0, w_hh, b_hh, w_ih, b_ih)
    y, n = _launch("lstm_stack", 4, xp0, w_hh, b_hh, w_ih, b_ih)
    lstm_stack.launches += n
    return y


def gru_stack(xp0, w_hh, b_hh, w_ih, b_ih) -> torch.Tensor:
    """K2, GRU: the whole unidirectional stack (``L >= 2``) in one launch
    from layer 0's ``xp0 = x @ W_ih0 + b_ih0``; (B, T, H) f32."""
    if _stack_gates(xp0, w_hh, b_hh, w_ih, b_ih) != 3:
        raise ValueError(f"gru_stack wants 3H gate columns, got w_hh {tuple(w_hh.shape)}")
    if xp0.device.type == "cpu":
        return stack_ref(xp0, w_hh, b_hh, w_ih, b_ih)
    y, n = _launch("gru_stack", 3, xp0, w_hh, b_hh, w_ih, b_ih)
    gru_stack.launches += n
    return y


lstm_scan.launches = 0
gru_scan.launches = 0
lstm_stack.launches = 0
gru_stack.launches = 0
