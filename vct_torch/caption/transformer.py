"""Transformer captioner, the S2VT v1 variant: the port of
``vct/caption/transformer.py`` (the reference's
``s2vt/main_configurable.py:138-313``).

  * encoder: frozen CNN frame features -> Linear -> + learned positions ->
    N pre-LN self-attention blocks
  * decoder: token embeddings + learned positions -> N pre-LN blocks of
    causal self-attention, cross-attention over frames, MLP -> vocab logits
  * teacher forcing runs the whole caption in parallel under a causal mask;
    the free-running decode re-decodes the fixed-length buffer once a step

The attention is ``flax.linen.MultiHeadDotProductAttention`` written out as
plain tensor products in Flax's layout, no fused kernel: query, key and value
projections to (heads, head_dim), the query scaled by head_dim**-0.5 before
the product, masked entries set to the f32 minimum, softmax, dropout on the
weights (one (q, k) mask broadcast over batch and heads, train mode only),
and the output projection from (heads, head_dim). Flax's ``nn.gelu`` is the
tanh form; LayerNorm eps is 1e-5.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from vct_torch.caption.models import FrameEncoderCNN, frames_of
from vct_torch.models.layers import Dropout

__all__ = ["MultiHeadDotProductAttention", "TransformerCaptioner"]


def _dense_general(in_shape, out_shape) -> nn.Linear:
    """A Linear that stands for a Flax ``DenseGeneral`` of kernel shape
    ``in_shape + out_shape``: ``vct_torch.bridge`` flattens that kernel
    (and the bias of shape ``out_shape``) into the Linear's layout."""
    n_in, n_out = 1, 1
    for d in in_shape:
        n_in *= d
    for d in out_shape:
        n_out *= d
    lin = nn.Linear(n_in, n_out)
    lin.flax_kernel_shape = tuple(in_shape) + tuple(out_shape)
    lin.flax_bias_shape = tuple(out_shape)
    return lin


class MultiHeadDotProductAttention(nn.Module):
    """Flax's ``MultiHeadDotProductAttention`` with its defaults: qkv and
    output width ``features`` (the query's), ``num_heads`` heads of
    ``features // num_heads``."""

    def __init__(self, features: int, num_heads: int, dropout: float = 0.0):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = features // num_heads
        heads = (num_heads, self.head_dim)
        self.query = _dense_general((features,), heads)
        self.key = _dense_general((features,), heads)
        self.value = _dense_general((features,), heads)
        self.out = _dense_general(heads, (features,))
        self.drop = Dropout(dropout)

    def forward(self, inputs_q, inputs_kv, mask=None):
        """inputs_q (B, Lq, F), inputs_kv (B, Lk, F); ``mask`` a bool
        (Lq, Lk) that keeps True entries."""
        b, lq, lk = inputs_q.shape[0], inputs_q.shape[1], inputs_kv.shape[1]
        h, d = self.num_heads, self.head_dim
        q = self.query(inputs_q).reshape(b, lq, h, d)
        k = self.key(inputs_kv).reshape(b, lk, h, d)
        v = self.value(inputs_kv).reshape(b, lk, h, d)
        # An f32 tensor divisor, as Flax divides (a scalar would multiply
        # by its reciprocal on the CPU).
        q = q / torch.full((1,), float(d), dtype=q.dtype, device=q.device).sqrt()
        w = torch.einsum("bqhd,bkhd->bhqk", q, k)
        if mask is not None:
            w = w.masked_fill(~mask, torch.finfo(w.dtype).min)
        w = torch.softmax(w, dim=-1)
        if self.training and self.drop.p > 0.0:
            w = w * self.drop(torch.ones(lq, lk, dtype=w.dtype, device=w.device))
        x = torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(b, lq, h * d)
        return self.out(x)


class _Block(nn.Module):
    def __init__(self, hidden: int, heads: int, dropout: float, cross: bool = False):
        super().__init__()
        self.cross = cross
        self.ln1 = nn.LayerNorm(hidden, eps=1e-5)
        self.self_attn = MultiHeadDotProductAttention(hidden, heads, dropout)
        if cross:
            self.ln_cross = nn.LayerNorm(hidden, eps=1e-5)
            self.cross_attn = MultiHeadDotProductAttention(hidden, heads, dropout)
        self.ln2 = nn.LayerNorm(hidden, eps=1e-5)
        self.mlp_in = nn.Linear(hidden, hidden * 4)
        self.mlp_out = nn.Linear(hidden * 4, hidden)
        self.drop = Dropout(dropout)

    def forward(self, x, enc=None, mask=None):
        y = self.ln1(x)
        x = x + self.self_attn(y, y, mask=mask)
        if self.cross:
            x = x + self.cross_attn(self.ln_cross(x), enc)
        y = self.mlp_out(F.gelu(self.mlp_in(self.ln2(x)), approximate="tanh"))
        return x + self.drop(y)


class TransformerCaptioner(nn.Module):
    def __init__(self, vocab_size: int, cnn_backbone: str = "resnet50",
                 cnn_output_size: int = 512, hidden_size: int = 512, num_heads: int = 8,
                 num_layers: int = 2, max_len: int = 30, start_token: int = 1,
                 dropout: float = 0.1):
        super().__init__()
        self.max_len = max_len
        self.start_token = start_token
        self.cnn = FrameEncoderCNN(cnn_backbone, cnn_output_size)
        self.enc_proj = nn.Linear(cnn_output_size, hidden_size)
        self.enc_pos = nn.Embedding(512, hidden_size)
        self.enc_blocks = [f"enc_{i}" for i in range(num_layers)]
        for name in self.enc_blocks:
            self.add_module(name, _Block(hidden_size, num_heads, dropout))
        self.tok_emb = nn.Embedding(vocab_size, hidden_size)
        self.dec_pos = nn.Embedding(max_len, hidden_size)
        self.dec_blocks = [f"dec_{i}" for i in range(num_layers)]
        for name in self.dec_blocks:
            self.add_module(name, _Block(hidden_size, num_heads, dropout, cross=True))
        self.out_ln = nn.LayerNorm(hidden_size, eps=1e-5)
        self.out = nn.Linear(hidden_size, vocab_size)

    def encode(self, video):
        b, t = video.shape[0], video.shape[1]
        feats = self.cnn(frames_of(video)).reshape(b, t, -1)
        x = self.enc_proj(feats) + self.enc_pos(torch.arange(t, device=feats.device))
        for name in self.enc_blocks:
            x = getattr(self, name)(x)
        return x

    def decode_logits(self, enc, tokens):
        """tokens (B, L) decoder inputs -> logits (B, L, V), causal."""
        L = tokens.shape[1]
        pos = torch.arange(L, device=tokens.device)
        x = self.tok_emb(tokens) + self.dec_pos(pos)
        causal = pos[None, :] <= pos[:, None]
        for name in self.dec_blocks:
            x = getattr(self, name)(x, enc=enc, mask=causal)
        return self.out(self.out_ln(x))

    def forward(self, video, targets=None):
        """Teacher-forced log-probs (B, max_len, V); the decoder input at
        step i is <start> then targets[:, :-1] (the v1 schedule). With
        ``targets=None`` a free-running greedy decode of the fixed buffer,
        re-decoded whole at every step, as ``vct`` does."""
        enc = self.encode(video)
        start = torch.full((video.shape[0], 1), self.start_token, dtype=torch.long,
                           device=enc.device)
        if targets is not None:
            inputs = torch.cat([start, targets[:, : self.max_len - 1].long()], dim=1)
            return torch.log_softmax(self.decode_logits(enc, inputs), dim=-1)
        buf = torch.cat([start, torch.zeros((video.shape[0], self.max_len - 1),
                                            dtype=torch.long, device=enc.device)], dim=1)
        for i in range(self.max_len - 1):
            nxt = torch.argmax(self.decode_logits(enc, buf)[:, i], dim=-1)
            buf = torch.cat([buf[:, : i + 1], nxt[:, None], buf[:, i + 2 :]], dim=1)
        return torch.log_softmax(self.decode_logits(enc, buf), dim=-1)

    def init_decode(self, video, max_len: int):
        if max_len > self.max_len:
            raise ValueError(
                f"beam max_len={max_len} exceeds the transformer's max_len={self.max_len} "
                "(positions beyond it would silently clamp)")
        return self.encode(video), ()

    def decode_step(self, tokens, i: int, state, enc):
        # No recurrent state: re-decode the causal prefix buffer and read
        # the logits at position i.
        return self.decode_logits(enc, tokens[:, : self.max_len])[:, i], state
