"""V1 stepwise RNN captioner, the LSTM/GRU option of the configurable S2VT
(``s2vt/main_configurable.py:136-313``): the port of ``vct/caption/v1_rnn.py``.

  * encoder (``main_configurable.py:136-189``): per-frame CNN + GAP + Linear
    to embed_size, then {LSTM, GRU} + self multi-head attention over time
  * decoder (``main_configurable.py:192-258``): token embedding, stepwise
    {LSTM, GRU} stack, cross multi-head attention from the RNN output onto
    the encoder sequence, Linear to vocab

As in ``vct``: teacher forcing runs the decoder RNN step by step over the
caption and the cross-attention once over all steps; the free-running
decode feeds back the argmax and attends to the whole encoder sequence each
step. The v1 reference decoder applies no dropout. The encoder RNN is the
plain recurrence (``"scan"``), as ``vct`` builds it.
"""

from __future__ import annotations

import torch
from torch import nn

from vct_torch.caption.models import FrameEncoderCNN, frames_of
from vct_torch.caption.transformer import MultiHeadDotProductAttention
from vct_torch.models.recurrent import GRU, LSTM

__all__ = ["StackedRNNCell", "V1RNNCaptioner"]


class StackedRNNCell(nn.Module):
    """Multi-layer torch-semantics LSTM/GRU *step* cell (one timestep).

    Weight layout as ``vct_torch.models.recurrent`` (``(in, G*H)``, gate
    orders [i, f, g, o] / [r, z, n], two bias vectors), names
    ``weight_ih_l{l}`` ... as in ``vct``."""

    # vct_torch.models.init_weights draws these U(-1/sqrt(H), 1/sqrt(H)).
    recurrent_params = True

    def __init__(self, input_size: int, hidden_size: int, num_layers: int, rnn_type: str):
        super().__init__()
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.rnn_type = rnn_type
        GH = (4 if rnn_type == "lstm" else 3) * hidden_size
        for layer in range(num_layers):
            in_size = input_size if layer == 0 else hidden_size
            for name, shape in (("weight_ih", (in_size, GH)), ("weight_hh", (hidden_size, GH)),
                                ("bias_ih", (GH,)), ("bias_hh", (GH,))):
                self.register_parameter(f"{name}_l{layer}", nn.Parameter(torch.empty(shape)))

    def _p(self, name: str, layer: int):
        return getattr(self, f"{name}_l{layer}")

    def init_state(self, batch: int, like: torch.Tensor):
        """Zeros of (num_layers, batch, H): (h, c) for the LSTM, h for the GRU."""
        zeros = like.new_zeros((self.num_layers, batch, self.hidden_size))
        return (zeros, zeros) if self.rnn_type == "lstm" else zeros

    def forward(self, x, state):
        """x (B, input_size); returns (top-layer h (B, H), new state)."""
        if self.rnn_type == "lstm":
            hs, cs = state
            new_h, new_c = [], []
            for layer in range(self.num_layers):
                gates = (x @ self._p("weight_ih", layer) + self._p("bias_ih", layer)
                         + hs[layer] @ self._p("weight_hh", layer) + self._p("bias_hh", layer))
                i, f, g, o = torch.chunk(gates, 4, dim=-1)
                c = torch.sigmoid(f) * cs[layer] + torch.sigmoid(i) * torch.tanh(g)
                h = torch.sigmoid(o) * torch.tanh(c)
                new_h.append(h)
                new_c.append(c)
                x = h
            return x, (torch.stack(new_h), torch.stack(new_c))
        hs = state
        new_h = []
        for layer in range(self.num_layers):
            xp = x @ self._p("weight_ih", layer) + self._p("bias_ih", layer)
            hp = hs[layer] @ self._p("weight_hh", layer) + self._p("bias_hh", layer)
            xr, xz, xn = torch.chunk(xp, 3, dim=-1)
            hr, hz, hn = torch.chunk(hp, 3, dim=-1)
            r = torch.sigmoid(xr + hr)
            z = torch.sigmoid(xz + hz)
            n = torch.tanh(xn + r * hn)
            h = (1.0 - z) * n + z * hs[layer]
            new_h.append(h)
            x = h
        return x, torch.stack(new_h)


class V1RNNCaptioner(nn.Module):
    def __init__(self, vocab_size: int, cnn_backbone: str = "resnet50", embed_size: int = 512,
                 hidden_size: int = 512, rnn_type: str = "gru", enc_layers: int = 1,
                 dec_layers: int = 3, num_heads: int = 8, max_len: int = 20,
                 start_token: int = 1):
        super().__init__()
        self.max_len = max_len
        self.start_token = start_token
        self.rnn_type = rnn_type
        self.cnn = FrameEncoderCNN(cnn_backbone, embed_size)
        rnn_cls = LSTM if rnn_type == "lstm" else GRU
        self.enc_rnn = rnn_cls(embed_size, hidden_size, enc_layers)
        self.enc_attn = MultiHeadDotProductAttention(hidden_size, num_heads)
        self.embed = nn.Embedding(vocab_size, embed_size)
        self.dec_cell = StackedRNNCell(embed_size, hidden_size, dec_layers, rnn_type)
        self.cross_attn = MultiHeadDotProductAttention(hidden_size, num_heads)
        self.fc = nn.Linear(hidden_size, vocab_size)

    def encode(self, video):
        """(B, T, H, W, 3) -> encoder sequence (B, T, hidden)."""
        b, t = video.shape[0], video.shape[1]
        rnn_out = self.enc_rnn(self.cnn(frames_of(video)).reshape(b, t, -1))
        return self.enc_attn(rnn_out, rnn_out)

    def _dec_rnn_seq(self, emb):
        """The decoder RNN stack over a whole (B, L, E) sequence -> (B, L, H)."""
        state = self.dec_cell.init_state(emb.shape[0], emb)
        outs = []
        for t in range(emb.shape[1]):
            out, state = self.dec_cell(emb[:, t], state)
            outs.append(out)
        return torch.stack(outs, dim=1)

    def forward(self, video, targets=None):
        """Teacher-forced log-probs (B, max_len, V); the decoder input at
        step i is <start> then targets[:, :-1]. With ``targets=None``, a
        free-running greedy decode feeds those inputs."""
        enc = self.encode(video)
        start = torch.full((video.shape[0], 1), self.start_token, dtype=torch.long,
                           device=enc.device)
        toks = self._greedy_tokens(enc) if targets is None else targets.long()
        inputs = torch.cat([start, toks[:, : self.max_len - 1]], dim=1)
        attn = self.cross_attn(self._dec_rnn_seq(self.embed(inputs)), enc)
        return torch.log_softmax(self.fc(attn), dim=-1)

    def _greedy_tokens(self, enc):
        """Free-running argmax over a given encoder sequence -> (B, max_len)."""
        state = self.dec_cell.init_state(enc.shape[0], enc)
        tok = torch.full((enc.shape[0],), self.start_token, dtype=torch.long, device=enc.device)
        toks = []
        for _ in range(self.max_len):
            out, state = self.dec_cell(self.embed(tok), state)
            tok = torch.argmax(self.fc(self.cross_attn(out[:, None, :], enc)[:, 0]), dim=-1)
            toks.append(tok)
        return torch.stack(toks, dim=1)

    def init_decode(self, video, max_len: int):
        enc = self.encode(video)
        state = self.dec_cell.init_state(enc.shape[0], enc)
        state = state if self.rnn_type == "lstm" else (state,)
        # The beam's state tensors lead with the batch axis: (B, L, H).
        return enc, tuple(s.transpose(0, 1) for s in state)

    def decode_step(self, tokens, i: int, state, enc):
        st = tuple(s.transpose(0, 1) for s in state)  # the cell's (L, B, H)
        out, new = self.dec_cell(self.embed(tokens[:, i]), st if self.rnn_type == "lstm" else st[0])
        new = new if self.rnn_type == "lstm" else (new,)
        logits = self.fc(self.cross_attn(out[:, None, :], enc)[:, 0])
        return logits, tuple(s.transpose(0, 1) for s in new)
