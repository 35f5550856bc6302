"""BLEU scoring, the caption trainer's eval metric: the port's copy of
``vct/caption/bleu.py``.

Uses nltk's ``sentence_bleu`` when available (the reference's scorer,
``s2vt/main_configurable.py:430-457``), with an equivalent native
implementation (modified n-gram precision, smoothing-free, brevity penalty —
Papineni et al. 2002) as fallback so the metric never silently disappears.
"""

from __future__ import annotations

import math
from collections import Counter
from typing import List, Sequence

__all__ = ["sentence_bleu", "corpus_average_bleu"]


def _ngrams(tokens: Sequence[str], n: int):
    return Counter(tuple(tokens[i : i + n]) for i in range(len(tokens) - n + 1))


def _native_sentence_bleu(
    references: List[List[str]], hypothesis: List[str], weights=(0.25,) * 4
) -> float:
    if not hypothesis:
        return 0.0
    log_prec = 0.0
    for n, w in enumerate(weights, start=1):
        if w == 0:
            continue
        hyp_ngrams = _ngrams(hypothesis, n)
        if not hyp_ngrams:
            return 0.0
        max_ref = Counter()
        for ref in references:
            for gram, count in _ngrams(ref, n).items():
                max_ref[gram] = max(max_ref[gram], count)
        clipped = sum(min(c, max_ref[g]) for g, c in hyp_ngrams.items())
        total = sum(hyp_ngrams.values())
        if clipped == 0:
            return 0.0
        log_prec += w * math.log(clipped / total)
    hyp_len = len(hypothesis)
    ref_len = min((abs(len(r) - hyp_len), len(r)) for r in references)[1]
    bp = 1.0 if hyp_len > ref_len else math.exp(1 - ref_len / max(hyp_len, 1))
    return bp * math.exp(log_prec)


def sentence_bleu(
    references: List[List[str]], hypothesis: List[str], weights=(0.25,) * 4
) -> float:
    try:
        from nltk.translate.bleu_score import sentence_bleu as nltk_bleu

        return float(nltk_bleu(references, hypothesis, weights=weights))
    except Exception:
        return _native_sentence_bleu(references, hypothesis, weights)


def corpus_average_bleu(pairs) -> float:
    """Mean sentence BLEU over (references, hypothesis) pairs — the
    reference's 'Average BLEU score' (main_configurable.py:456-457)."""
    scores = [sentence_bleu(refs, hyp) for refs, hyp in pairs]
    return sum(scores) / len(scores) if scores else 0.0
