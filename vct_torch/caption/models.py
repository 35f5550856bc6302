"""S2VT captioning models: the port of ``vct/caption/models.py``.

  * ``FrameEncoderCNN`` — frozen backbone + Linear projection to
    ``cnn_output_size`` (``s2vt/beam_search.py:260-294`` PretrainedCNN); all
    B·T frames go through the backbone in one batch
  * ``EncoderRNN`` — Linear embed + GRU (``beam_search.py:230-243``)
  * ``LuongAttention`` — general attention: score = (W q) K^T
    (``beam_search.py:297-308``)
  * ``AttnDecoderStep`` — one decode step: embed token, attend with the
    GRU hidden as query, GRU over [embed; context], vocab projection
    (``beam_search.py:311-352`` forward_step)
  * ``S2VTModel`` — teacher-forced training forward, one decoder step per
    target token (``beam_search.py:354-381``)

Submodules and parameters carry ``vct``'s Flax names (``cnn.cnn`` the
backbone, ``cnn.fc``, ``encoder.gru``, ``decoder.gru_w_ih`` in ``(in, 3H)``
layout ...), so ``vct_torch.bridge`` maps its weights mechanically. The
backbone always runs under ``torch.no_grad`` (``vct``'s ``stop_gradient``)
and keeps BatchNorm at its running statistics. The GRUs are the plain
recurrences (``"scan"``), as ``vct`` builds them: no kernel is on this path.
Dropout acts in train mode only, from each ``Dropout``'s generator.

Every captioner family offers the beam search of ``vct_torch.caption.beam``
the same two methods: ``init_decode(video, max_len)`` -> (encoder output,
state tuple) and ``decode_step(tokens, i, state, enc)`` -> (logits, state),
each state tensor with a leading batch·beam axis.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from vct_torch.models.backbones import build_backbone
from vct_torch.models.layers import Dropout
from vct_torch.models.recurrent import GRU

__all__ = ["FrameEncoderCNN", "EncoderRNN", "LuongAttention", "AttnDecoderStep", "S2VTModel"]


class FrameEncoderCNN(nn.Module):
    """Frozen backbone + trainable projection (beam_search.py:260-294: only
    the feature extractor sits under no_grad, :290-291; the fc trains).

    ``features_only`` returns the raw frozen-backbone features (the
    bit-constant, cacheable part); ``from_features`` consumes such features
    and applies just the trainable fc: the trainer's feature cache."""

    def __init__(self, backbone: str = "resnet50", output_size: int = 512):
        super().__init__()
        self.cnn, feat = build_backbone(backbone)
        self.fc = nn.Linear(feat, output_size)

    def forward(self, frames, *, from_features: bool = False, features_only: bool = False):
        """(N, H, W, 3) frames, or (N, F) features with ``from_features``."""
        if from_features:
            feats = frames
        else:
            with torch.no_grad():  # vct's stop_gradient
                # (N, H, W, 3) -> an NCHW view whose strides are channels-last.
                feats = self.cnn(frames.permute(0, 3, 1, 2))
            if features_only:
                return feats
        return self.fc(feats)


def frames_of(video):
    """(B, T, ...) -> (B·T, ...)."""
    return video.reshape((video.shape[0] * video.shape[1],) + tuple(video.shape[2:]))


class EncoderRNN(nn.Module):
    """Linear embed + (multi-layer) GRU.

    v2 uses one layer (``beam_search.py:230-243``); the 1s2vt variant stacks
    four (``s2vt/1s2vt_models.py:233``). With ``num_layers == 1`` the final
    hidden is (B, H); with more layers it is the per-layer stack
    (B, num_layers, H), which seeds the equally deep decoder GRU."""

    def __init__(self, input_size: int, hidden_size: int, dropout: float = 0.1,
                 num_layers: int = 1):
        super().__init__()
        self.num_layers = num_layers
        self.embedding = nn.Linear(input_size, hidden_size)
        self.drop = Dropout(dropout)
        self.gru = GRU(hidden_size, hidden_size, num_layers)

    def forward(self, x):  # (B, T, F)
        x = self.drop(self.embedding(x))
        if self.num_layers == 1:
            y = self.gru(x)
            return y, y[:, -1, :]  # outputs, final hidden
        return self.gru(x, return_final=True)  # outputs, (B, L, H)


class LuongAttention(nn.Module):
    def __init__(self, hidden_size: int):
        super().__init__()
        self.attn = nn.Linear(hidden_size, hidden_size)

    def forward(self, query, keys):
        """query (B, H); keys (B, T, H) -> (context (B, H), weights (B, T))."""
        q = self.attn(query)
        scores = torch.einsum("bh,bth->bt", q, keys)
        weights = torch.softmax(scores, dim=-1)
        context = torch.einsum("bt,bth->bh", weights, keys)
        return context, weights


class AttnDecoderStep(nn.Module):
    """One decoder step. Parameters are shared across steps, so the same
    module drives teacher forcing, greedy, and beam decode.

    ``num_layers == 1`` is the v2 decoder (``beam_search.py:311-352``);
    ``num_layers > 1`` is the 1s2vt variant (``s2vt/1s2vt_models.py:
    296-341``): a stacked GRU whose layer 0 sees [embed; context] (2H) and
    whose attention query is the last layer's hidden only. Layer 0's
    parameters keep the unsuffixed names (``gru_w_ih``), layer i >= 1 takes
    ``_l{i}``; the layout is ``(in, 3H)``, gate order [r, z, n]."""

    # Its own parameters are a recurrence's: vct_torch.models.init_weights
    # draws them U(-1/sqrt(H), 1/sqrt(H)), as torch inits a GRU.
    recurrent_params = True

    def __init__(self, hidden_size: int, vocab_size: int, dropout: float = 0.1,
                 num_layers: int = 1):
        super().__init__()
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.embedding = nn.Embedding(vocab_size, hidden_size)
        self.drop = Dropout(dropout)
        self.attention = LuongAttention(hidden_size)
        H = hidden_size
        for layer in range(num_layers):
            sfx = "" if layer == 0 else f"_l{layer}"
            in_size = 2 * H if layer == 0 else H
            for name, shape in (("gru_w_ih", (in_size, 3 * H)), ("gru_w_hh", (H, 3 * H)),
                                ("gru_b_ih", (3 * H,)), ("gru_b_hh", (3 * H,))):
                self.register_parameter(f"{name}{sfx}", nn.Parameter(torch.empty(shape)))
        self.out = nn.Linear(hidden_size, vocab_size)

    def _gru_cell(self, x_in, h, layer: int):
        sfx = "" if layer == 0 else f"_l{layer}"
        H = self.hidden_size
        xp = x_in @ getattr(self, f"gru_w_ih{sfx}") + getattr(self, f"gru_b_ih{sfx}")
        hp = h @ getattr(self, f"gru_w_hh{sfx}") + getattr(self, f"gru_b_hh{sfx}")
        r = torch.sigmoid(xp[:, :H] + hp[:, :H])
        z = torch.sigmoid(xp[:, H : 2 * H] + hp[:, H : 2 * H])
        nq = torch.tanh(xp[:, 2 * H :] + r * hp[:, 2 * H :])
        return (1.0 - z) * nq + z * h

    def forward(self, token, hidden, encoder_outputs):
        """token (B,) int; hidden (B, H) for num_layers == 1 else
        (B, num_layers, H); encoder_outputs (B, T, H).

        Returns (logits (B, V), new_hidden (same shape as hidden),
        attn_weights (B, T))."""
        emb = self.drop(self.embedding(token))
        query = hidden if self.num_layers == 1 else hidden[:, -1]
        context, weights = self.attention(query, encoder_outputs)
        x = torch.cat([emb, context], dim=-1)  # (B, 2H)
        if self.num_layers == 1:
            new_hidden = self._gru_cell(x, hidden, 0)
            top = new_hidden
        else:
            layer_in, states = x, []
            for i in range(self.num_layers):
                layer_in = self._gru_cell(layer_in, hidden[:, i], i)
                states.append(layer_in)
            new_hidden = torch.stack(states, dim=1)  # (B, L, H)
            top = layer_in
        return self.out(top), new_hidden, weights


class S2VTModel(nn.Module):
    """Full encoder-decoder with a teacher-forced forward.

    ``rnn_layers`` selects the variant: 1 = the v2 model
    (``beam_search.py:229-382``), 4 = the 1s2vt model
    (``s2vt/1s2vt_models.py:227-378``: 4-layer encoder GRU whose per-layer
    final hiddens seed the 4-layer decoder GRU, attention queried by the
    last layer's hidden only)."""

    # The trainer's feature cache: the frozen backbone's output is
    # bit-constant across epochs, so it is extracted once.
    supports_feature_cache = True

    def __init__(self, vocab_size: int, cnn_backbone: str = "resnet50",
                 cnn_output_size: int = 512, hidden_size: int = 512, max_len: int = 30,
                 start_token: int = 1, dropout: float = 0.1, rnn_layers: int = 1):
        super().__init__()
        self.max_len = max_len
        self.start_token = start_token
        self.cnn = FrameEncoderCNN(cnn_backbone, cnn_output_size)
        self.encoder = EncoderRNN(cnn_output_size, hidden_size, dropout, rnn_layers)
        self.decoder = AttnDecoderStep(hidden_size, vocab_size, dropout, rnn_layers)

    def encode(self, video, from_features: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        b, t = video.shape[0], video.shape[1]
        feats = self.cnn(frames_of(video), from_features=from_features).reshape(b, t, -1)
        return self.encoder(feats)

    def extract_features(self, video):
        """(B, T, H, W, 3) -> frozen-backbone features (B, T, F)."""
        b, t = video.shape[0], video.shape[1]
        return self.cnn(frames_of(video), features_only=True).reshape(b, t, -1)

    def forward(self, video, targets=None, from_features: bool = False):
        """Teacher-forced (or free-running) decode: log-probs (B, max_len, V).

        The decoder input at step 0 is <start>, at step i the target
        targets[:, i-1] under teacher forcing (the reference's schedule,
        beam_search.py:330-341), else the argmax of the previous step."""
        enc_out, hidden = self.encode(video, from_features=from_features)
        token = torch.full((video.shape[0],), self.start_token, dtype=torch.long,
                           device=enc_out.device)
        logits = []
        for i in range(self.max_len):
            step_logits, hidden, _ = self.decoder(token, hidden, enc_out)
            logits.append(step_logits)
            token = targets[:, i].long() if targets is not None else torch.argmax(step_logits, -1)
        return torch.log_softmax(torch.stack(logits, dim=1), dim=-1)

    def init_decode(self, video, max_len: int):
        enc_out, hidden = self.encode(video)
        return enc_out, (hidden,)

    def decode_step(self, tokens, i: int, state, enc):
        logits, hidden, _ = self.decoder(tokens[:, i], state[0], enc)
        return logits, (hidden,)
