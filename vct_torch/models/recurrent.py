"""LSTM / GRU temporal heads.

Port of ``vct/models/recurrent.py``: torch ``nn.LSTM`` / ``nn.GRU``
semantics as the reference's LRCN uses them (batch-first, multi-layer,
optionally bidirectional, gate orders [i, f, g, o] and [r, z, n], two bias
vectors per layer), with ``vct``'s parameter names and ``(in, G*H)``
layout: ``weight_ih_l{l}{suffix}`` (in, G*H), ``weight_hh_l{l}{suffix}``
(H, G*H), ``bias_ih_l{l}{suffix}`` and ``bias_hh_l{l}{suffix}`` (G*H,),
suffix ``""`` or ``"_reverse"``.

Each direction's input projection ``x @ W_ih + b_ih`` over all steps is one
``torch.matmul`` outside the recurrence. ``scan_impl`` picks the recurrence:
"scan" runs the plain loops, "pallas" the CUDA kernels (the name is the
reference's). With "pallas" a unidirectional stack of two or more layers
without ``return_final`` runs as one K2 launch (``lstm_stack`` /
``gru_stack``); everything else runs layer by layer through K5
(``lstm_scan`` / ``gru_scan``), the reverse direction by flipping time
around it. The output is f32 on every path.
"""

from __future__ import annotations

import torch
from torch import nn

from vct_torch.ops import lstm as _ops

__all__ = ["LSTM", "GRU", "RNNStack"]


class _RecurrentBase(nn.Module):
    # Overridden per cell. The ops are plain functions read through
    # type(self), so they are never bound as methods.
    n_gates = 0
    _scan = {}  # scan_impl -> single-layer op
    _stack = None  # the fused-stack kernel op

    def __init__(self, input_size: int, hidden_size: int, num_layers: int = 1,
                 bidirectional: bool = False, scan_impl: str = "scan"):
        super().__init__()
        if scan_impl not in ("scan", "pallas"):
            raise ValueError(f"scan_impl must be 'scan' or 'pallas', got {scan_impl!r}")
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.bidirectional = bidirectional
        self.scan_impl = scan_impl
        GH = self.n_gates * hidden_size
        dirs = 2 if bidirectional else 1
        for layer in range(num_layers):
            in_size = input_size if layer == 0 else hidden_size * dirs
            for suffix in ("", "_reverse")[:dirs]:
                for name, shape in (("weight_ih", (in_size, GH)), ("weight_hh", (hidden_size, GH)),
                                    ("bias_ih", (GH,)), ("bias_hh", (GH,))):
                    self.register_parameter(f"{name}_l{layer}{suffix}",
                                            nn.Parameter(torch.empty(shape)))

    def _p(self, name, layer, suffix=""):
        return getattr(self, f"{name}_l{layer}{suffix}")

    def _direction(self, x, layer, suffix, reverse):
        """One direction of one layer. x: (B, T, in) -> (B, T, H)."""
        xp = torch.matmul(x, self._p("weight_ih", layer, suffix)) + self._p("bias_ih", layer, suffix)
        if reverse:
            xp = torch.flip(xp, dims=(1,))
        op = type(self)._scan[self.scan_impl]
        y = op(xp, self._p("weight_hh", layer, suffix), self._p("bias_hh", layer, suffix))
        return torch.flip(y, dims=(1,)) if reverse else y

    def _fused_stack(self, x):
        """The whole unidirectional stack in one K2 launch; layer 0's input
        projection is one matmul outside it."""
        xp0 = torch.matmul(x, self._p("weight_ih", 0)) + self._p("bias_ih", 0)
        layers = range(self.num_layers)
        return type(self)._stack(
            xp0,
            torch.stack([self._p("weight_hh", l) for l in layers]),
            torch.stack([self._p("bias_hh", l) for l in layers]),
            torch.stack([self._p("weight_ih", l) for l in layers[1:]]),
            torch.stack([self._p("bias_ih", l) for l in layers[1:]]),
        )

    def forward(self, x, return_final: bool = False):
        """x (B, T, in) -> outputs (B, T, H[*2 if bidirectional]).

        ``return_final=True`` also returns each layer's final hidden state,
        (B, num_layers, H) (torch's ``h_n`` with the layer axis behind the
        batch). Unidirectional only.
        """
        if return_final and self.bidirectional:
            raise ValueError("return_final supports unidirectional RNNs only")
        if (self.scan_impl == "pallas" and not self.bidirectional
                and self.num_layers >= 2 and not return_final):
            return self._fused_stack(x)
        finals = []
        for layer in range(self.num_layers):
            y = self._direction(x, layer, "", reverse=False)
            if self.bidirectional:
                y = torch.cat([y, self._direction(x, layer, "_reverse", reverse=True)], dim=-1)
            x = y
            finals.append(x[:, -1, :])
        if return_final:
            return x, torch.stack(finals, dim=1)
        return x


class LSTM(_RecurrentBase):
    n_gates = 4
    _scan = {"scan": _ops.lstm_scan_ref, "pallas": _ops.lstm_scan}
    _stack = _ops.lstm_stack


class GRU(_RecurrentBase):
    n_gates = 3
    _scan = {"scan": _ops.gru_scan_ref, "pallas": _ops.gru_scan}
    _stack = _ops.gru_stack


class RNNStack(nn.Module):
    """String-dispatched temporal head, lstm | gru; the recurrent module is
    the child named after ``rnn_type`` (``rnn.lstm`` / ``rnn.gru`` in the
    LRCN)."""

    def __init__(self, rnn_type: str, input_size: int, hidden_size: int, num_layers: int,
                 bidirectional: bool = False, scan_impl: str = "scan"):
        super().__init__()
        cls = {"lstm": LSTM, "gru": GRU}[rnn_type]
        self.rnn_type = rnn_type
        self.add_module(rnn_type, cls(input_size, hidden_size, num_layers,
                                      bidirectional=bidirectional, scan_impl=scan_impl))

    def forward(self, x):
        return getattr(self, self.rnn_type)(x)
