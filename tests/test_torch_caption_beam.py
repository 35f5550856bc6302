"""vct_torch's beam search and greedy decode against vct's, on the CPU.

For every captioner family at the small size of
tests/torch_caption_common.py (the same seeded weights in both, through the
bridge): beam tokens equal and scores within atol = rtol = 1e-5 at K = 1 and
K = 3, and greedy tokens equal. The search's own rules are held on a
scripted decoder: ties keep the lower index (``jax.lax.top_k``'s order),
finished beams continue only with <pad> at zero cost, and the dead beams'
scores follow vct's NEG_INF arithmetic.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_caption_common as common
from vct.caption.beam import beam_search as vct_beam_search
from vct.caption.beam import decode_tokens as vct_decode_tokens
from vct.caption.beam import greedy_decode as vct_greedy_decode
from vct_torch.caption.beam import NEG_INF, beam_search, decode_tokens, greedy_decode

TOL = 1e-5


@pytest.fixture(scope="module", params=list(common.KINDS))
def kind_pair(request):
    return request.param, common.pair(request.param)


@pytest.mark.parametrize("beam_width", [1, 3])
def test_beam_search_matches_vct(kind_pair, beam_width):
    kind, (vct_model, variables, model, _) = kind_pair
    videos, _ = common.inputs()
    want_t, want_s = vct_beam_search(vct_model, variables, jnp.asarray(videos),
                                     beam_width=beam_width, max_len=common.MAX_LEN)
    model.train()  # the search decodes in eval mode whatever the model's mode
    got_t, got_s = beam_search(model, torch.from_numpy(videos), beam_width, common.MAX_LEN)
    assert model.training
    model.eval()
    assert got_t.shape == (common.B, common.MAX_LEN + 1)
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t), err_msg=kind)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), atol=TOL, rtol=TOL,
                               err_msg=kind)


def test_greedy_decode_matches_vct(kind_pair):
    kind, (vct_model, variables, model, _) = kind_pair
    videos, _ = common.inputs()
    for max_len in (common.MAX_LEN, 3):
        want = vct_greedy_decode(vct_model, variables, jnp.asarray(videos), max_len=max_len)
        got = greedy_decode(model, torch.from_numpy(videos), max_len)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=kind)


def test_transformer_beam_refuses_a_longer_caption():
    _, _, model, _ = common.pair("transformer")
    videos, _ = common.inputs()
    with pytest.raises(ValueError, match="exceeds the transformer's max_len"):
        beam_search(model, torch.from_numpy(videos[:1]), 2, common.MAX_LEN + 1)


def test_decode_tokens_matches_vct():
    vocab = common.vocab()
    for row in ([1, 4, 5, 2, 7], [1, 0, 4, 99, 5], [4, 1, 5, 6], [2, 4]):
        assert decode_tokens(row, vocab) == vct_decode_tokens(row, vocab)


class _Scripted(torch.nn.Module):
    """A decoder whose next-token log-probs depend only on the last token:
    ``table[last]`` (V, V). No encoder, no state."""

    def __init__(self, table):
        super().__init__()
        self.table = torch.as_tensor(table, dtype=torch.float32)

    def init_decode(self, video, max_len):
        return torch.zeros(video.shape[0], 1), ()

    def decode_step(self, tokens, i, state, enc):
        return self.table[tokens[:, i]], state


def _reference_search(table, K, max_len, start=1, end=2, pad=0):
    """vct's search loop over the scripted decoder, in JAX: lax.top_k and
    vct's NEG_INF arithmetic (vct/caption/beam.py:131-168)."""
    table = jnp.asarray(table, jnp.float32)
    V = table.shape[0]
    tokens = jnp.full((1, K, max_len + 1), pad, jnp.int32).at[:, :, 0].set(start)
    scores = jnp.where(jnp.arange(K)[None, :] == 0, 0.0, NEG_INF) * jnp.ones((1, K))
    done = jnp.zeros((1, K), bool)
    for i in range(max_len):
        logp = jax.nn.log_softmax(table[tokens[0, :, i]], axis=-1)[None]
        pad_row = jnp.full((V,), NEG_INF).at[pad].set(0.0)
        logp = jnp.where(done[:, :, None], pad_row[None, None, :], logp)
        scores, idx = jax.lax.top_k((scores[:, :, None] + logp).reshape(1, K * V), K)
        beam, tok = idx // V, (idx % V).astype(jnp.int32)
        tokens = tokens[jnp.arange(1)[:, None], beam].at[:, :, i + 1].set(tok)
        done = done[jnp.arange(1)[:, None], beam] | (tok == end)
    best = jnp.argmax(scores, axis=1)
    return np.asarray(tokens[0, best[0]]), float(scores[0, best[0]])


@pytest.mark.parametrize("case", ["all_ties", "end_early", "dead_beams"])
def test_search_rules_match_vct_on_a_scripted_decoder(case):
    """All-equal log-probs (ties everywhere: the lowest indices win); an
    early <end> (only <pad> follows, its score frozen); K above the live
    candidates at step 0 (beams scored from NEG_INF stay in the search)."""
    V = 6
    if case == "all_ties":
        table, K = np.zeros((V, V)), 3
    elif case == "end_early":
        table = np.log(np.full((V, V), 0.05))
        table[1, 2] = np.log(0.6)  # <start> -> <end> is best
        table[1, 4] = np.log(0.3)
        table[4, 5] = np.log(0.9)
        K = 2
    else:
        table = np.full((V, V), -50.0)
        table[:, 3] = 0.0
        K = 8  # more beams than the first step's V live candidates
    got_t, got_s = beam_search(_Scripted(table), torch.zeros(1, 1), K, 5)
    want_t, want_s = _reference_search(table, K, 5)
    np.testing.assert_array_equal(got_t[0].numpy(), want_t)
    np.testing.assert_allclose(got_s[0].item(), want_s, rtol=1e-6)
    if case == "end_early":
        assert got_t[0].tolist() == [1, 2, 0, 0, 0, 0]
