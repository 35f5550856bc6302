"""The timed path broken underneath a run, past the harness's look for a
card: each fault a cell can have comes out as ``correct`` false. (One card
a cell: no exchange between cards to leave out.)"""

from __future__ import annotations

import numpy as np
import pytest
from common import run_tiny, tiny_copy


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_copy(tmp_path_factory.mktemp("bench"))


def _altered_answer(classify):
    def fault(model, clips, **kw):
        probs = classify(model, clips, **kw).copy()
        probs[0] = probs[0][::-1]  # one video's answer altered where it is produced
        return probs
    return fault


def _half_batch(classify):
    def fault(model, clips, batch_size=32, **kw):
        half = len(clips) // 2  # the second half left out, given the first half's answers
        probs = classify(model, clips[:half], batch_size=half, **kw)
        return np.concatenate([probs, probs])
    return fault


@pytest.mark.parametrize("cell", ["tiny_mamba_serve", "tiny_lstm_serve"])
@pytest.mark.parametrize("fault", [_altered_answer, _half_batch], ids=["altered", "half"])
def test_serve_fault_is_not_correct(root, monkeypatch, cell, fault):
    from vct_torch.serve import deployment

    monkeypatch.setattr(deployment, "classify_videos", fault(deployment.classify_videos))
    result, lines = run_tiny(root, cell)
    assert result["correct"] is False, lines
