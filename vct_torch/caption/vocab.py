"""Vocabulary — word<->index with special tokens and a frequency threshold:
the port's copy of ``vct/caption/vocab.py`` (``s2vt/beam_search.py:25-68`` in
the reference). Token ids: <pad>=0, <start>=1, <end>=2, <unk>=3."""

from __future__ import annotations

import json
import string
from typing import Dict, Iterable, List

__all__ = ["Vocabulary", "tokenize_caption"]

PAD, START, END, UNK = "<pad>", "<start>", "<end>", "<unk>"


def tokenize_caption(caption: str) -> List[str]:
    """Lowercase, strip punctuation, whitespace split
    (beam_search.py:119-128)."""
    caption = caption.lower().translate(str.maketrans("", "", string.punctuation))
    return caption.split()


class Vocabulary:
    def __init__(self, freq_threshold: int = 1):
        self.freq_threshold = freq_threshold
        self.word2idx: Dict[str, int] = {}
        self.idx2word: Dict[int, str] = {}
        for tok in (PAD, START, END, UNK):
            self.add_word(tok)

    def __len__(self) -> int:
        return len(self.word2idx)

    def __getitem__(self, word: str) -> int:
        return self.word2idx.get(word, self.word2idx[UNK])

    def add_word(self, word: str) -> None:
        if word not in self.word2idx:
            idx = len(self.word2idx)
            self.word2idx[word] = idx
            self.idx2word[idx] = word

    def build_vocabulary(self, sentences: Iterable[str]) -> None:
        """Count TOKENIZED words (lowercase, punctuation stripped).

        Deliberate fix of a reference bug: ``beam_search.py:55-66`` counts
        raw ``sentence.split()`` tokens while encoding looks words up via
        ``tokenize_caption`` (``:119-128``), so every capitalized or
        punctuated word maps to <unk> there. Building from the same
        tokenization the encoder uses makes the vocab actually reachable."""
        freq: Dict[str, int] = {}
        for sentence in sentences:
            for word in tokenize_caption(sentence):
                freq[word] = freq.get(word, 0) + 1
        for word, count in freq.items():
            if count >= self.freq_threshold:
                self.add_word(word)

    def numericalize(self, tokens: List[str]) -> List[int]:
        unk = self.word2idx[UNK]
        return [self.word2idx.get(tok, unk) for tok in tokens]

    def denumericalize(self, indices: Iterable[int]) -> List[str]:
        return [self.idx2word[int(i)] for i in indices]

    # persistence (the reference pickles the whole model instead; we keep the
    # vocab alongside the checkpoint manifest)
    def to_dict(self) -> dict:
        return {"freq_threshold": self.freq_threshold, "word2idx": self.word2idx}

    @classmethod
    def from_dict(cls, d: dict) -> "Vocabulary":
        v = cls(d.get("freq_threshold", 1))
        for word, idx in sorted(d["word2idx"].items(), key=lambda kv: kv[1]):
            v.word2idx[word] = idx
            v.idx2word[idx] = word
        return v

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f)

    @classmethod
    def load(cls, path: str) -> "Vocabulary":
        with open(path) as f:
            return cls.from_dict(json.load(f))
