"""On-device beam search for every captioner family: the port of
``vct/caption/beam.py``.

The search keeps fixed-shape state on the device:

    tokens (B, K, L+1) | scores (B, K) | the family's state (B*K, ...) | done

Each step runs the family's one-step decoder (``decode_step``) over all B·K
beams in one batch, expands to K·V candidates, masks finished beams (only a
zero-cost <pad> continuation survives) and keeps the best K. The best K are
taken by a stable descending sort, so ties keep the lower index first, as
``jax.lax.top_k`` does (``torch.topk`` on CUDA promises no order). The
arithmetic with ``NEG_INF = -1e9`` is ``vct``'s, so dead beams score as
there. No value goes to the host inside the loop.

Greedy decode is the model's own free-running forward, as in ``vct``.
"""

from __future__ import annotations

import contextlib
from typing import List

import torch

__all__ = ["beam_search", "greedy_decode", "decode_tokens"]

NEG_INF = -1e9


@contextlib.contextmanager
def _deterministic(model):
    """Eval mode and no autograd for the block (``vct`` decodes with
    ``deterministic=True``); the model's mode is restored after."""
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad():
            yield
    finally:
        model.train(was_training)


def beam_search(model, video, beam_width: int = 3, max_len: int = 30, start_token: int = 1,
                end_token: int = 2, pad_token: int = 0):
    """Returns (tokens (B, max_len+1) incl. the leading <start>, scores (B,)).

    Works for every captioner family (S2VT, v1 LSTM/GRU, transformer)."""
    with _deterministic(model):
        enc, state = model.init_decode(video, max_len)
        B, K = video.shape[0], beam_width
        dev = enc.device
        # Broadcast the encoder output and the state across beams: (B*K, ...).
        enc = torch.repeat_interleave(enc, K, dim=0)
        state = tuple(torch.repeat_interleave(s, K, dim=0) for s in state)
        tokens = torch.full((B, K, max_len + 1), pad_token, dtype=torch.long, device=dev)
        tokens[:, :, 0] = start_token
        # Only beam 0 is live initially (all beams identical otherwise).
        scores = torch.where(torch.arange(K, device=dev)[None, :] == 0,
                             torch.tensor(0.0, device=dev),
                             torch.tensor(NEG_INF, device=dev)) * torch.ones((B, K), device=dev)
        done = torch.zeros((B, K), dtype=torch.bool, device=dev)
        batch_idx = torch.arange(B, device=dev)[:, None]
        for i in range(max_len):
            logits, new_state = model.decode_step(tokens.reshape(B * K, max_len + 1), i, state, enc)
            logp = torch.log_softmax(logits, dim=-1).reshape(B, K, -1)
            V = logp.shape[-1]
            # Finished beams: only <pad> continues, at zero cost.
            pad_row = torch.full((V,), NEG_INF, device=dev)
            pad_row[pad_token] = 0.0
            logp = torch.where(done[:, :, None], pad_row[None, None, :], logp)
            flat = (scores[:, :, None] + logp).reshape(B, K * V)
            order = torch.sort(flat, dim=1, descending=True, stable=True)
            scores, idx = order.values[:, :K], order.indices[:, :K]
            beam_idx = idx // V  # which parent beam
            tok_idx = idx % V  # which token
            # Reorder all beam state by parent beam.
            tokens = tokens[batch_idx, beam_idx]
            tokens[:, :, i + 1] = tok_idx
            state = tuple(s.reshape((B, K) + s.shape[1:])[batch_idx, beam_idx].reshape(s.shape)
                          for s in new_state)
            done = done[batch_idx, beam_idx] | (tok_idx == end_token)
        best = torch.argmax(scores, dim=1)
        rows = torch.arange(B, device=dev)
        return tokens[rows, best], scores[rows, best]


def greedy_decode(model, video, max_len: int = 30):
    """Free-running argmax decode through the model's own forward
    (targets=None), truncated to ``max_len`` tokens (greedy decoding is
    prefix-deterministic). The reference's non-beam caption variant decodes
    this way (``s2vt/edit_configurable.py:305-343``)."""
    with _deterministic(model):
        return torch.argmax(model(video), dim=-1)[:, :max_len]


def decode_tokens(token_row, vocab, start_token=1, end_token=2, pad_token=0) -> List[str]:
    """Token ids -> words, stripping start/end/pad (beam_search.py:433-435)."""
    words = []
    for t in [int(x) for x in token_row]:
        if t == end_token:
            break
        if t in (start_token, pad_token):
            continue
        words.append(vocab.idx2word.get(t, "<unk>"))
    return words
