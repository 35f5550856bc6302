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
steps) and how its three designs meet that: "registers" for ``H <= 64``
(a block a batch row, the weights in registers), "clusters" for ``64 < H
<= 256`` (a thread-block cluster of 8 or 16 CTAs a group of batch rows,
each CTA a slice of the units with its weights in registers, each step's
h_t stored into every CTA's shared memory with ``st.async`` and waited for
on an mbarrier) and "columns" above (a block a row, weights through L2, so
any H runs).
``design`` says which one a shape takes, ``plan`` the clusters' shape.
Weights keep ``vct``'s ``(in, G*H)`` layout; gate orders are torch's, [i,
f, g, o] and [r, z, n], with GRU's ``n = tanh(x_n + r * (h @ W_hn +
b_hn))``.

The backward (``lstm_scan_bwd``, ``gru_scan_bwd``, ``lstm_stack_bwd``,
``gru_stack_bwd``) launches ``vct_torch/csrc/lstm_bwd.cu`` once per layer,
the stack's layers in reverse: the kernel walks a layer's chain of steps in
reverse time (``layer_bwd_ref`` is its plain version; the same three
designs over the same ranges of H, ``bwd_design``, "clusters" with the
forward's plan and each step's gate gradients stored into every CTA). What is
not on that chain is a batched matrix product or sum over the saved outputs
(``torch.bmm``, ``torch.mm``), as ``vct`` leaves it to XLA: every
layer's recurrent and input parts before the layers, the weight gradients
after them, and between two layers only ``dy = dx @ W_ih^T``. ``vct`` has
no Pallas kernel there (its custom_vjps differentiate the ``lax.scan``
references).
Where no input requires a gradient, each forward wrapper calls a registered
operator, ``vct_torch::rnn_scan`` (K5) or ``vct_torch::rnn_stack`` (K2),
whose CPU implementation is the plain PyTorch version (``lstm_scan_ref``,
``gru_scan_ref``, ``stack_ref``: loops over time) and whose CUDA
implementation is the kernel; an exported program calls the same operator.
Where one does, a CPU tensor goes to the plain version, which autograd
differentiates, and a CUDA tensor to an autograd node whose forward is the
kernel and whose backward is the backward kernel; the stack's forward then
also saves every layer's outputs. The backward wrappers take a CPU tensor
to ``scan_bwd_ref`` / ``stack_bwd_ref`` and a CUDA tensor to the kernel,
which runs or the wrapper raises.
"""

from __future__ import annotations

import torch

from vct_torch.ops import _build

__all__ = [
    "lstm_scan", "gru_scan", "lstm_stack", "gru_stack",
    "lstm_scan_ref", "gru_scan_ref", "stack_ref", "design",
    "lstm_scan_bwd", "gru_scan_bwd", "lstm_stack_bwd", "gru_stack_bwd",
    "scan_bwd_ref", "stack_bwd_ref", "layer_bwd_ref", "bwd_design", "plan",
]

DESIGNS = ("columns", "registers", "clusters")


def design(T: int, H: int, L: int, n_gates: int) -> str:
    """The kernel design a CUDA launch takes for these shapes, as the
    kernel library decides it (``vct_rnn_plan``); needs the built library."""
    return DESIGNS[_build.load_kernels().vct_rnn_plan(T, H, L, n_gates)]


def plan(B: int, T: int, H: int, L: int, n_gates: int, backward: bool = False,
         cluster: int = 0, rows: int = 0) -> dict | None:
    """The "clusters" design's plan for a batch of B rows, as the kernel
    library chooses it from the shapes (``vct_rnn_cluster_plan``; forward
    and backward share it), or the plan (cluster, rows) given: ``cluster``
    CTAs a thread-block cluster, ``rows`` batch rows a cluster, ``clusters``
    clusters, and ``resident``, how many of them the card holds at once
    (``cudaOccupancyMaxActiveClusters`` for the kernel and its shared
    memory, forward or backward). None where the design does not take the
    shapes. Needs the built library and a CUDA device."""
    lib = _build.load_kernels()
    code = lib.vct_rnn_cluster_plan(B, H, n_gates)
    if not code:
        return None
    if not cluster:
        cluster, rows = code >> 8, code & 255
    fit = (lib.vct_rnn_bwd_fit(B, T, H, n_gates, cluster, rows) if backward
           else lib.vct_rnn_fwd_fit(B, T, H, L, n_gates, cluster, rows))
    if fit < 0:
        _build.check(lib, -fit, f"rnn cluster plan ({cluster}, {rows}) at B={B} T={T} H={H}")
    return {"cluster": cluster, "rows": rows, "clusters": -(-B // rows), "resident": fit}


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


def _launch(name, n_gates, xp, w_hh, b_hh, w_ih=None, b_ih=None, save=False, cluster=(0, 0)):
    """Run the forward kernel on CUDA tensors; return (y, saves, number of
    launches). With ``save``, saves holds the outputs of layers 0..L-2,
    (L-1, B, T, H), for the backward. ``cluster``: the "clusters" plan
    (CTAs a cluster, rows a cluster) to launch, (0, 0) for the shapes' own."""
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
        err = lib.vct_rnn_fwd_with(
            xp.data_ptr(), w_hh.data_ptr(), b_hh.data_ptr(),
            None if w_ih is None else w_ih.data_ptr(),
            None if b_ih is None else b_ih.data_ptr(),
            y.data_ptr(), None if hs is None or hs.numel() == 0 else hs.data_ptr(),
            B, T, H, L, n_gates, *cluster, stream,
        )
    _build.check(lib, err, f"{name} kernel launch")
    return y, hs, 1


def bwd_design(T: int, H: int, n_gates: int) -> str:
    """The backward kernel design a CUDA launch takes for these shapes, as
    the kernel library decides it (``vct_rnn_bwd_plan``); needs the built
    library."""
    return DESIGNS[_build.load_kernels().vct_rnn_bwd_plan(T, H, n_gates)]


def layer_bwd_ref(n_gates, x, r, bx, b_hh, h, w_hh, dy, dx, dr, db) -> None:
    """Plain version of one backward kernel launch (``vct_rnn_bwd``), the
    same inputs and outputs. x (B, T, G*H) and bx (G*H,) or None: the gate
    input parts are x + bx; r (B, T, G*H): r[:, t] = h_t @ W_hh, so that
    step t+1's recurrent part is r[:, t] + b_hh (step 0's is b_hh); h (B, T,
    H): the layer's outputs; w_hh (H, G*H); dy (B, T, H).
    Writes dx (B, T, G*H), the gradient of x; dr (B, T, G*H), the gradient
    of r (of step t+1's recurrent part at t, 0 at t = T-1); db (2, B, G*H),
    each row's sums over time of the recurrent parts' gradients (step 0's
    included) and of dx."""
    B, T, GH = x.shape
    H = GH // n_gates
    rec = torch.cat([r.new_zeros(B, 1, GH), r[:, :-1]], dim=1) + b_hh
    if bx is not None:
        x = x + bx
    if n_gates == 4:
        pi, pf, pg, po = (x + rec).chunk(4, dim=-1)
        i, f, g, o = torch.sigmoid(pi), torch.sigmoid(pf), torch.tanh(pg), torch.sigmoid(po)
        cs, c = [], x.new_zeros(B, H)
        for t in range(T):
            c = f[:, t] * c + i[:, t] * g[:, t]
            cs.append(c)
        c = torch.stack(cs, dim=1)
        c_prev = torch.cat([c.new_zeros(B, 1, H), c[:, :-1]], dim=1)
        tc = torch.tanh(c)
    else:
        xr, xz, xn = x.chunk(3, dim=-1)
        hr, hz, hn = rec.chunk(3, dim=-1)
        rg, z = torch.sigmoid(xr + hr), torch.sigmoid(xz + hz)
        n = torch.tanh(xn + rg * hn)
        h_prev = torch.cat([h.new_zeros(B, 1, H), h[:, :-1]], dim=1)
    dxs, drs = [None] * T, [None] * T
    dh_rec, dc = x.new_zeros(B, H), x.new_zeros(B, H)
    for t in reversed(range(T)):
        dh = dy[:, t] + dh_rec
        if n_gates == 4:
            it, ft, gt, ot, tct = i[:, t], f[:, t], g[:, t], o[:, t], tc[:, t]
            dct = dc + dh * ot * (1 - tct * tct)
            dxs[t] = drs[t] = torch.cat([dct * gt * it * (1 - it),
                                         dct * c_prev[:, t] * ft * (1 - ft),
                                         dct * it * (1 - gt * gt), dh * tct * ot * (1 - ot)], -1)
            dc = dct * ft
            dh_rec = drs[t] @ w_hh.t()
        else:
            rt, zt, nt = rg[:, t], z[:, t], n[:, t]
            dpn = dh * (1 - zt) * (1 - nt * nt)
            dpz = dh * (h_prev[:, t] - nt) * zt * (1 - zt)
            dpr = dpn * hn[:, t] * rt * (1 - rt)
            dxs[t] = torch.cat([dpr, dpz, dpn], -1)
            drs[t] = torch.cat([dpr, dpz, dpn * rt], -1)
            dh_rec = drs[t] @ w_hh.t() + dh * zt
    dx.copy_(torch.stack(dxs, dim=1))
    drt = torch.stack(drs, dim=1)
    dr[:, :-1] = drt[:, 1:]
    dr[:, -1] = 0
    db[0] = drt.sum(dim=1)
    db[1] = dx.sum(dim=1)


def _layer_bwd(n_gates, x, r, bx, b_hh, h, w_hh, dy, dx, dr, db, cluster=(0, 0)) -> None:
    """One layer's backward kernel, ``layer_bwd_ref``'s contract on CUDA
    tensors; ``cluster`` as for ``_launch``."""
    B, T, GH = x.shape
    lib = _build.load_kernels()
    with torch.cuda.device(x.device):
        err = lib.vct_rnn_bwd_with(
            x.data_ptr(), r.data_ptr(), None if bx is None else bx.data_ptr(), b_hh.data_ptr(),
            h.data_ptr(), w_hh.data_ptr(), dy.data_ptr(), dx.data_ptr(), dr.data_ptr(),
            db.data_ptr(), B, T, GH // n_gates, n_gates, *cluster,
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(lib, err, "rnn backward kernel launch")


def _split_rows(t, ns):
    """(L, N, C) -> (L*ns, N/ns, C): each layer's rows in ns chunks (a view)."""
    return t.reshape(t.shape[0] * ns, t.shape[1] // ns, t.shape[2])


def _stack_backward(n_gates, xp0, w_hh, b_hh, w_ih, b_ih, outs, gy):
    """The gradients of a stack of L >= 1 layers from every layer's outputs
    ``outs`` (L, B, T, H), its layers in reverse: (dxp0, dw_hh, db_hh,
    dw_ih, db_ih, kernel launches). Only a launch a layer and dy's product
    lie on the layers' chain; the recurrent and input parts before it and
    the weight gradients after it are batched products and sums."""
    L, H, GH = w_hh.shape
    B, T = xp0.shape[:2]
    BT = B * T
    flat = outs.reshape(L, BT, H)
    rec = torch.bmm(flat, w_hh)  # h_t @ W_hh; the kernel adds the biases
    xs = torch.bmm(flat[:-1], w_ih) if L > 1 else None
    dx = xp0.new_empty(L, B, T, GH)
    dr = xp0.new_empty(L, B, T, GH)
    db = xp0.new_empty(L, 2, B, GH)
    dy, launches = gy, 0
    for l in reversed(range(L)):
        x, bx = (xp0, None) if l == 0 else (xs[l - 1].view(B, T, GH), b_ih[l - 1])
        _layer_bwd(n_gates, x, rec[l].view(B, T, GH), bx, b_hh[l], outs[l], w_hh[l], dy, dx[l],
                   dr[l], db[l])
        launches += 1
        if l:
            dy = torch.mm(dx[l].view(BT, GH), w_ih[l - 1].t()).view(B, T, H)
    # dW_hh[l] = sum_t h_t^T dr[l, t] and dW_ih[l-1] = sum_t y_{l-1, t}^T dx_l,
    # over B*T rows cut into ns chunks: cuBLAS gives a product of so few
    # output tiles one block a tile, each walking all B*T rows.
    ns = 1
    while ns < 16 and BT % (2 * ns) == 0 and BT // (2 * ns) >= 64:
        ns *= 2
    part = xp0.new_empty(2 * L - 1, ns, H, GH)
    torch.bmm(_split_rows(flat, ns).transpose(1, 2), _split_rows(dr.view(L, BT, GH), ns),
              out=part[:L].view(L * ns, H, GH))
    if L > 1:
        torch.bmm(_split_rows(flat[:-1], ns).transpose(1, 2),
                  _split_rows(dx[1:].view(L - 1, BT, GH), ns),
                  out=part[L:].view((L - 1) * ns, H, GH))
    dw = part.sum(dim=1)
    dbs = db.sum(dim=2)  # (L, 2, G*H)
    return dx[0], dw[:L], dbs[:, 0], dw[L:], dbs[1:, 1], launches


def _layer_backward(n_gates, xp, w_hh, b_hh, y, gy):
    """K5's backward, the one-layer stack: (dxp, dw_hh, db_hh, kernel
    launches)."""
    H, GH = w_hh.shape
    none_w, none_b = w_hh.new_empty(0, H, GH), b_hh.new_empty(0, GH)
    dx, dw_hh, db_hh, _, _, launches = _stack_backward(n_gates, xp, w_hh[None], b_hh[None],
                                                       none_w, none_b, y[None], gy)
    return dx, dw_hh[0], db_hh[0], launches


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


def _scan_bwd(name, n_gates, xp, w_hh, b_hh, y, gy, counter):
    _check_layer(name, n_gates, xp, w_hh, b_hh)
    if xp.device.type == "cpu":
        return scan_bwd_ref(xp, w_hh, b_hh, gy)
    _check_cuda(name, {"xp": xp, "w_hh": w_hh, "b_hh": b_hh, "y": y, "gy": gy})
    if xp.numel() == 0 or w_hh.shape[0] == 0:
        return torch.zeros_like(xp), torch.zeros_like(w_hh), torch.zeros_like(b_hh)
    *grads, launches = _layer_backward(n_gates, xp, w_hh, b_hh, y, gy)
    counter.launches += launches
    return tuple(grads)


def lstm_scan_bwd(xp, w_hh, b_hh, y, gy):
    """K5 backward, LSTM: (dxp, dw_hh, db_hh) of ``y = lstm_scan(xp, w_hh,
    b_hh)`` against gy; one kernel launch on CUDA."""
    return _scan_bwd("lstm_scan_bwd", 4, xp, w_hh, b_hh, y, gy, lstm_scan_bwd)


def gru_scan_bwd(xp, w_hh, b_hh, y, gy):
    """K5 backward, GRU: (dxp, dw_hh, db_hh) of ``y = gru_scan(xp, w_hh,
    b_hh)`` against gy; one kernel launch on CUDA."""
    return _scan_bwd("gru_scan_bwd", 3, xp, w_hh, b_hh, y, gy, gru_scan_bwd)


def _stack_bwd(name, n_gates, xp0, w_hh, b_hh, w_ih, b_ih, hs, y, gy, counter):
    _check_stack(name, n_gates, xp0, w_hh, b_hh, w_ih, b_ih)
    if xp0.device.type == "cpu":
        return stack_bwd_ref(xp0, w_hh, b_hh, w_ih, b_ih, gy)
    _check_cuda(name, {"xp0": xp0, "w_hh": w_hh, "b_hh": b_hh, "w_ih": w_ih, "b_ih": b_ih,
                       "hs": hs, "y": y, "gy": gy})
    if xp0.numel() == 0:
        return tuple(torch.zeros_like(t) for t in (xp0, w_hh, b_hh, w_ih, b_ih))
    outs = torch.cat([hs, y.unsqueeze(0)])
    *grads, launches = _stack_backward(n_gates, xp0, w_hh, b_hh, w_ih, b_ih, outs, gy)
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
        y, _ = _kernel_forward(name, n_gates, xp, w_hh, b_hh)
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
        y, hs = _kernel_forward(name, n_gates, xp0, w_hh, b_hh, w_ih, b_ih, save=True)
        ctx.save_for_backward(xp0, w_hh, b_hh, w_ih, b_ih, hs, y)
        ctx.bwd = lstm_stack_bwd if n_gates == 4 else gru_stack_bwd
        return y

    @staticmethod
    def backward(ctx, gy):
        return (None, None, *ctx.bwd(*ctx.saved_tensors, gy.contiguous()))


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _kernel_forward(name, n_gates, xp, w_hh, b_hh, w_ih=None, b_ih=None, save=False):
    """The forward kernel on CUDA tensors, its launch counted on the wrapper
    ``name``: (y, saves) as ``_launch`` gives them."""
    y, hs, n = _launch(name, n_gates, xp, w_hh, b_hh, w_ih, b_ih, save=save)
    _WRAPPERS[name].launches += n
    return y, hs


def _check_device(name, xp) -> None:
    if xp.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"{name}: no kernel for device {xp.device}")


def _scan(name, n_gates, xp, w_hh, b_hh):
    _check_layer(name, n_gates, xp, w_hh, b_hh)
    _check_device(name, xp)
    if not _needs_grad(xp, w_hh, b_hh):
        return torch.ops.vct_torch.rnn_scan(xp, w_hh, b_hh, n_gates)
    if xp.device.type == "cpu":
        return (lstm_scan_ref if n_gates == 4 else gru_scan_ref)(xp, w_hh, b_hh)
    return _Scan.apply(name, n_gates, xp, w_hh, b_hh)


def _check_stack(name, n_gates, xp0, w_hh, b_hh, w_ih, b_ih) -> None:
    if _stack_gates(xp0, w_hh, b_hh, w_ih, b_ih) != n_gates:
        raise ValueError(f"{name} wants {n_gates}H gate columns, got w_hh {tuple(w_hh.shape)}")


def _stack(name, n_gates, xp0, w_hh, b_hh, w_ih, b_ih):
    _check_stack(name, n_gates, xp0, w_hh, b_hh, w_ih, b_ih)
    _check_device(name, xp0)
    args = (xp0, w_hh, b_hh, w_ih, b_ih)
    if not _needs_grad(*args):
        return torch.ops.vct_torch.rnn_stack(*args, n_gates)
    if xp0.device.type == "cpu":
        return stack_ref(*args)
    return _Stack.apply(name, n_gates, *args)


def lstm_scan(xp, w_hh, b_hh) -> torch.Tensor:
    """K5, LSTM: one layer from ``xp = x @ W_ih + b_ih``; (B, T, H) f32."""
    return _scan("lstm_scan", 4, xp, w_hh, b_hh)


def gru_scan(xp, w_hh, b_hh) -> torch.Tensor:
    """K5, GRU: one layer from ``xp = x @ W_ih + b_ih``; (B, T, H) f32."""
    return _scan("gru_scan", 3, xp, w_hh, b_hh)


def lstm_stack(xp0, w_hh, b_hh, w_ih, b_ih) -> torch.Tensor:
    """K2, LSTM: the whole unidirectional stack (``L >= 2``) in one launch
    from layer 0's ``xp0 = x @ W_ih0 + b_ih0``; (B, T, H) f32."""
    return _stack("lstm_stack", 4, xp0, w_hh, b_hh, w_ih, b_ih)


def gru_stack(xp0, w_hh, b_hh, w_ih, b_ih) -> torch.Tensor:
    """K2, GRU: the whole unidirectional stack (``L >= 2``) in one launch
    from layer 0's ``xp0 = x @ W_ih0 + b_ih0``; (B, T, H) f32."""
    return _stack("gru_stack", 3, xp0, w_hh, b_hh, w_ih, b_ih)


@torch.library.custom_op("vct_torch::rnn_scan", mutates_args=(), device_types="cpu")
def _scan_op(xp: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor,
             n_gates: int) -> torch.Tensor:
    """K5's operator, CPU implementation: the plain version, uncounted."""
    return (lstm_scan_ref if n_gates == 4 else gru_scan_ref)(xp, w_hh, b_hh)


@_scan_op.register_kernel("cuda")
def _scan_op_cuda(xp, w_hh, b_hh, n_gates):
    """K5's operator, CUDA implementation: the checked, counted launch."""
    name = "lstm_scan" if n_gates == 4 else "gru_scan"
    _check_layer(name, n_gates, xp, w_hh, b_hh)
    return _kernel_forward(name, n_gates, xp, w_hh, b_hh)[0]


@_scan_op.register_fake
def _scan_op_fake(xp, w_hh, b_hh, n_gates):
    return xp.new_empty((xp.shape[0], xp.shape[1], w_hh.shape[0]))


@torch.library.custom_op("vct_torch::rnn_stack", mutates_args=(), device_types="cpu")
def _stack_op(xp0: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor, w_ih: torch.Tensor,
              b_ih: torch.Tensor, n_gates: int) -> torch.Tensor:
    """K2's operator, CPU implementation: the plain version, uncounted."""
    return stack_ref(xp0, w_hh, b_hh, w_ih, b_ih)


@_stack_op.register_kernel("cuda")
def _stack_op_cuda(xp0, w_hh, b_hh, w_ih, b_ih, n_gates):
    """K2's operator, CUDA implementation: the checked, counted launch."""
    name = "lstm_stack" if n_gates == 4 else "gru_stack"
    _check_stack(name, n_gates, xp0, w_hh, b_hh, w_ih, b_ih)
    return _kernel_forward(name, n_gates, xp0, w_hh, b_hh, w_ih, b_ih)[0]


@_stack_op.register_fake
def _stack_op_fake(xp0, w_hh, b_hh, w_ih, b_ih, n_gates):
    return xp0.new_empty((xp0.shape[0], xp0.shape[1], w_hh.shape[1]))


_WRAPPERS = {f.__name__: f for f in (lstm_scan, gru_scan, lstm_stack, gru_stack)}
lstm_scan.launches = 0
gru_scan.launches = 0
lstm_stack.launches = 0
gru_stack.launches = 0
lstm_scan_bwd.launches = 0
gru_scan_bwd.launches = 0
lstm_stack_bwd.launches = 0
gru_stack_bwd.launches = 0
