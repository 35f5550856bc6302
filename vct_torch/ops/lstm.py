"""K2 and K5: the LSTM / GRU recurrences, forward and backward.

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
[r, z, n], with GRU's ``n = tanh(x_n + r * (h @ W_hn + b_hn))``.

The backward (``lstm_scan_bwd``, ``gru_scan_bwd``, ``lstm_stack_bwd``,
``gru_stack_bwd``) launches ``vct_torch/csrc/lstm_bwd.cu`` once per layer,
the stack's layers in reverse: the kernel gives the gate gradients of a
layer in reverse time from its saved outputs; the weight gradients and the
stack's inter-layer gradients are matrix products over saved tensors
(``torch.matmul``), as ``vct`` leaves them to XLA. ``vct`` has no Pallas
kernel there (its custom_vjps differentiate the ``lax.scan`` references).
On CUDA each forward wrapper records an autograd node whose backward is
that kernel when an input requires a gradient; the stack's forward then
also saves every layer's outputs.

Each wrapper dispatches by device: a CPU tensor goes to the plain PyTorch
version (``lstm_scan_ref``, ``gru_scan_ref``, ``stack_ref``: loops over
time, which autograd differentiates; ``scan_bwd_ref``, ``stack_bwd_ref``),
a CUDA tensor to the kernel, which runs or the wrapper raises.
"""

from __future__ import annotations

import torch

from vct_torch.ops import _build

__all__ = [
    "lstm_scan", "gru_scan", "lstm_stack", "gru_stack",
    "lstm_scan_ref", "gru_scan_ref", "stack_ref", "design",
    "lstm_scan_bwd", "gru_scan_bwd", "lstm_stack_bwd", "gru_stack_bwd",
    "scan_bwd_ref", "stack_bwd_ref",
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


def _check_cuda(name, tensors: dict) -> None:
    """Raise unless every given tensor is an f32, contiguous CUDA tensor on
    the first one's device."""
    first = next(iter(tensors.values()))
    if first.device.type != "cuda":
        raise RuntimeError(f"{name}: no kernel for device {first.device}")
    for tname, t in tensors.items():
        if t is None:
            continue
        if t.device != first.device:
            raise ValueError(f"{name}: {tname} is on {t.device}, xp on {first.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"the {name} kernel takes f32, {tname} is {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"the {name} kernel takes contiguous tensors, {tname} is not")


def _launch(name, n_gates, xp, w_hh, b_hh, w_ih=None, b_ih=None, save=False):
    """Run the forward kernel on CUDA tensors; return (y, saves, number of
    launches). With ``save``, saves holds the outputs of layers 0..L-2,
    (L-1, B, T, H), for the backward."""
    _check_cuda(name, {"xp": xp, "w_hh": w_hh, "b_hh": b_hh, "w_ih": w_ih, "b_ih": b_ih})
    B, T, GH = xp.shape
    H = GH // n_gates
    L = 1 if w_hh.dim() == 2 else w_hh.shape[0]
    y = torch.empty((B, T, H), dtype=torch.float32, device=xp.device)
    hs = torch.empty((L - 1, B, T, H), dtype=torch.float32, device=xp.device) if save else None
    if y.numel() == 0:
        return y, hs, 0
    lib = _build.load_kernels()
    with torch.cuda.device(xp.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.vct_rnn_fwd(
            xp.data_ptr(), w_hh.data_ptr(), b_hh.data_ptr(),
            None if w_ih is None else w_ih.data_ptr(),
            None if b_ih is None else b_ih.data_ptr(),
            y.data_ptr(), None if hs is None or hs.numel() == 0 else hs.data_ptr(),
            B, T, H, L, n_gates, stream,
        )
    _build.check(lib, err, f"{name} kernel launch")
    return y, hs, 1


def _layer_bwd(n_gates, x, h, w_hh, b_hh, dy):
    """One layer's backward kernel: (dx, dr), the gradients of the gate
    input parts x and of the recurrent parts h_{t-1} @ W_hh + b_hh (the same
    tensor for the LSTM)."""
    B, T, GH = x.shape
    H = GH // n_gates
    dx = torch.empty_like(x)
    dr = torch.empty_like(x) if n_gates == 3 else None
    lib = _build.load_kernels()
    act = torch.empty(lib.vct_rnn_bwd_scratch(B, T, H, n_gates), dtype=torch.float32,
                      device=x.device)
    with torch.cuda.device(x.device):
        err = lib.vct_rnn_bwd(
            x.data_ptr(), h.data_ptr(), w_hh.data_ptr(), b_hh.data_ptr(), dy.data_ptr(),
            dx.data_ptr(), None if dr is None else dr.data_ptr(), act.data_ptr(),
            B, T, H, n_gates, torch.cuda.current_stream().cuda_stream,
        )
    _build.check(lib, err, "rnn backward kernel launch")
    return dx, (dx if dr is None else dr)


def _weight_grads(h, dr):
    """dW_hh = sum_t h_{t-1}^T dr_t (h_{-1} = 0) and db_hh = sum_t dr_t."""
    H, GH = h.shape[2], dr.shape[2]
    h_prev = torch.nn.functional.pad(h[:, :-1], (0, 0, 1, 0))
    return h_prev.reshape(-1, H).t() @ dr.reshape(-1, GH), dr.sum(dim=(0, 1))


def _stack_backward(n_gates, xp0, w_hh, b_hh, w_ih, b_ih, hs, y, gy):
    """The stack's gradients, its layers in reverse: (dxp0, dw_hh, db_hh,
    dw_ih, db_ih, kernel launches)."""
    L, H, GH = w_hh.shape
    B, T = xp0.shape[:2]
    outs = [hs[l] for l in range(L - 1)] + [y]
    grads = [torch.empty_like(t) for t in (w_hh, b_hh, w_ih, b_ih)]
    dw_hh, db_hh, dw_ih, db_ih = grads
    dy, dxp0, launches = gy, None, 0
    for l in reversed(range(L)):
        if l == 0:
            x = xp0
        else:
            x = torch.addmm(b_ih[l - 1], outs[l - 1].reshape(-1, H), w_ih[l - 1]).view(B, T, GH)
        dx, dr = _layer_bwd(n_gates, x, outs[l], w_hh[l], b_hh[l], dy.contiguous())
        launches += 1
        dw_hh[l], db_hh[l] = _weight_grads(outs[l], dr)
        if l == 0:
            dxp0 = dx
        else:
            dw_ih[l - 1] = outs[l - 1].reshape(-1, H).t() @ dx.reshape(-1, GH)
            db_ih[l - 1] = dx.sum(dim=(0, 1))
            dy = (dx.reshape(-1, GH) @ w_ih[l - 1].t()).view(B, T, H)
    return dxp0, dw_hh, db_hh, dw_ih, db_ih, launches


def scan_bwd_ref(xp, w_hh, b_hh, gy):
    """Plain version of K5's backward: autograd through ``lstm_scan_ref`` or
    ``gru_scan_ref`` (by the gate count). Returns (dxp, dw_hh, db_hh)."""
    ref = lstm_scan_ref if w_hh.shape[1] == 4 * w_hh.shape[0] else gru_scan_ref
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (xp, w_hh, b_hh)]
        return torch.autograd.grad(ref(*leaves), leaves, gy)


def stack_bwd_ref(xp0, w_hh, b_hh, w_ih, b_ih, gy):
    """Plain version of K2's backward: autograd through ``stack_ref``.
    Returns (dxp0, dw_hh, db_hh, dw_ih, db_ih)."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (xp0, w_hh, b_hh, w_ih, b_ih)]
        return torch.autograd.grad(stack_ref(*leaves), leaves, gy)


def _scan_bwd(name, n_gates, xp, w_hh, b_hh, y, gy):
    _check_layer(name, n_gates, xp, w_hh, b_hh)
    if xp.device.type == "cpu":
        return scan_bwd_ref(xp, w_hh, b_hh, gy)
    _check_cuda(name, {"xp": xp, "w_hh": w_hh, "b_hh": b_hh, "y": y, "gy": gy})
    if xp.numel() == 0 or w_hh.shape[0] == 0:
        return torch.zeros_like(xp), torch.zeros_like(w_hh), torch.zeros_like(b_hh)
    dx, dr = _layer_bwd(n_gates, xp, y, w_hh, b_hh, gy)
    return (dx, *_weight_grads(y, dr))


def lstm_scan_bwd(xp, w_hh, b_hh, y, gy):
    """K5 backward, LSTM: (dxp, dw_hh, db_hh) of ``y = lstm_scan(xp, w_hh,
    b_hh)`` against gy; one kernel launch on CUDA."""
    grads = _scan_bwd("lstm_scan_bwd", 4, xp, w_hh, b_hh, y, gy)
    if xp.device.type == "cuda" and xp.numel():
        lstm_scan_bwd.launches += 1
    return grads


def gru_scan_bwd(xp, w_hh, b_hh, y, gy):
    """K5 backward, GRU: (dxp, dw_hh, db_hh) of ``y = gru_scan(xp, w_hh,
    b_hh)`` against gy; one kernel launch on CUDA."""
    grads = _scan_bwd("gru_scan_bwd", 3, xp, w_hh, b_hh, y, gy)
    if xp.device.type == "cuda" and xp.numel():
        gru_scan_bwd.launches += 1
    return grads


def _stack_bwd(name, n_gates, xp0, w_hh, b_hh, w_ih, b_ih, hs, y, gy, counter):
    if _stack_gates(xp0, w_hh, b_hh, w_ih, b_ih) != n_gates:
        raise ValueError(f"{name} wants {n_gates}H gate columns, got w_hh {tuple(w_hh.shape)}")
    if xp0.device.type == "cpu":
        return stack_bwd_ref(xp0, w_hh, b_hh, w_ih, b_ih, gy)
    _check_cuda(name, {"xp0": xp0, "w_hh": w_hh, "b_hh": b_hh, "w_ih": w_ih, "b_ih": b_ih,
                       "hs": hs, "y": y, "gy": gy})
    if xp0.numel() == 0:
        return tuple(torch.zeros_like(t) for t in (xp0, w_hh, b_hh, w_ih, b_ih))
    *grads, launches = _stack_backward(n_gates, xp0, w_hh, b_hh, w_ih, b_ih, hs, y, gy)
    counter.launches += launches
    return tuple(grads)


def lstm_stack_bwd(xp0, w_hh, b_hh, w_ih, b_ih, hs, y, gy):
    """K2 backward, LSTM: (dxp0, dw_hh, db_hh, dw_ih, db_ih) of ``y =
    lstm_stack(...)`` against gy, from the forward's saved outputs hs of
    layers 0..L-2; one kernel launch a layer on CUDA."""
    return _stack_bwd("lstm_stack_bwd", 4, xp0, w_hh, b_hh, w_ih, b_ih, hs, y, gy,
                      lstm_stack_bwd)


def gru_stack_bwd(xp0, w_hh, b_hh, w_ih, b_ih, hs, y, gy):
    """K2 backward, GRU: as ``lstm_stack_bwd``."""
    return _stack_bwd("gru_stack_bwd", 3, xp0, w_hh, b_hh, w_ih, b_ih, hs, y, gy,
                      gru_stack_bwd)


class _Scan(torch.autograd.Function):
    """K5's kernel, with its backward kernel as the gradient."""

    @staticmethod
    def forward(ctx, name, n_gates, xp, w_hh, b_hh):
        y, _, _ = _launch(name, n_gates, xp, w_hh, b_hh)
        ctx.save_for_backward(xp, w_hh, b_hh, y)
        ctx.bwd = lstm_scan_bwd if n_gates == 4 else gru_scan_bwd
        return y

    @staticmethod
    def backward(ctx, gy):
        return (None, None, *ctx.bwd(*ctx.saved_tensors, gy.contiguous()))


class _Stack(torch.autograd.Function):
    """K2's kernel, saving every layer's outputs, with its backward kernel
    (a launch a layer) as the gradient."""

    @staticmethod
    def forward(ctx, name, n_gates, xp0, w_hh, b_hh, w_ih, b_ih):
        y, hs, _ = _launch(name, n_gates, xp0, w_hh, b_hh, w_ih, b_ih, save=True)
        ctx.save_for_backward(xp0, w_hh, b_hh, w_ih, b_ih, hs, y)
        ctx.bwd = lstm_stack_bwd if n_gates == 4 else gru_stack_bwd
        return y

    @staticmethod
    def backward(ctx, gy):
        return (None, None, *ctx.bwd(*ctx.saved_tensors, gy.contiguous()))


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _run_scan(name, n_gates, xp, w_hh, b_hh):
    """K5 on CUDA tensors: with an autograd node where a gradient is needed."""
    if _needs_grad(xp, w_hh, b_hh):
        return _Scan.apply(name, n_gates, xp, w_hh, b_hh), int(xp.numel() > 0)
    y, _, n = _launch(name, n_gates, xp, w_hh, b_hh)
    return y, n


def _run_stack(name, n_gates, xp0, w_hh, b_hh, w_ih, b_ih):
    """K2 on CUDA tensors: with an autograd node where a gradient is needed."""
    if _needs_grad(xp0, w_hh, b_hh, w_ih, b_ih):
        return _Stack.apply(name, n_gates, xp0, w_hh, b_hh, w_ih, b_ih), int(xp0.numel() > 0)
    y, _, n = _launch(name, n_gates, xp0, w_hh, b_hh, w_ih, b_ih)
    return y, n


def lstm_scan(xp, w_hh, b_hh) -> torch.Tensor:
    """K5, LSTM: one layer from ``xp = x @ W_ih + b_ih``; (B, T, H) f32."""
    _check_layer("lstm_scan", 4, xp, w_hh, b_hh)
    if xp.device.type == "cpu":
        return lstm_scan_ref(xp, w_hh, b_hh)
    y, n = _run_scan("lstm_scan", 4, xp, w_hh, b_hh)
    lstm_scan.launches += n
    return y


def gru_scan(xp, w_hh, b_hh) -> torch.Tensor:
    """K5, GRU: one layer from ``xp = x @ W_ih + b_ih``; (B, T, H) f32."""
    _check_layer("gru_scan", 3, xp, w_hh, b_hh)
    if xp.device.type == "cpu":
        return gru_scan_ref(xp, w_hh, b_hh)
    y, n = _run_scan("gru_scan", 3, xp, w_hh, b_hh)
    gru_scan.launches += n
    return y


def lstm_stack(xp0, w_hh, b_hh, w_ih, b_ih) -> torch.Tensor:
    """K2, LSTM: the whole unidirectional stack (``L >= 2``) in one launch
    from layer 0's ``xp0 = x @ W_ih0 + b_ih0``; (B, T, H) f32."""
    if _stack_gates(xp0, w_hh, b_hh, w_ih, b_ih) != 4:
        raise ValueError(f"lstm_stack wants 4H gate columns, got w_hh {tuple(w_hh.shape)}")
    if xp0.device.type == "cpu":
        return stack_ref(xp0, w_hh, b_hh, w_ih, b_ih)
    y, n = _run_stack("lstm_stack", 4, xp0, w_hh, b_hh, w_ih, b_ih)
    lstm_stack.launches += n
    return y


def gru_stack(xp0, w_hh, b_hh, w_ih, b_ih) -> torch.Tensor:
    """K2, GRU: the whole unidirectional stack (``L >= 2``) in one launch
    from layer 0's ``xp0 = x @ W_ih0 + b_ih0``; (B, T, H) f32."""
    if _stack_gates(xp0, w_hh, b_hh, w_ih, b_ih) != 3:
        raise ValueError(f"gru_stack wants 3H gate columns, got w_hh {tuple(w_hh.shape)}")
    if xp0.device.type == "cpu":
        return stack_ref(xp0, w_hh, b_hh, w_ih, b_ih)
    y, n = _run_stack("gru_stack", 3, xp0, w_hh, b_hh, w_ih, b_ih)
    gru_stack.launches += n
    return y


lstm_scan.launches = 0
gru_scan.launches = 0
lstm_stack.launches = 0
gru_stack.launches = 0
lstm_scan_bwd.launches = 0
gru_scan_bwd.launches = 0
lstm_stack_bwd.launches = 0
gru_stack_bwd.launches = 0
