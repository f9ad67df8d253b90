"""Synthetic TweetEval-sentiment generator (DESIGN.md §2).

Real dataset: 45,615 train / 12,284 test / 2,000 val tweets, 3 classes
(negative=0, neutral=1, positive=2).  Surrogate: class-conditional unigram
mixtures over a small word vocabulary — sentiment-bearing words are drawn
with class-dependent rates, fillers uniformly, lengths ~ N(18, 6) words.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

N_CLASSES = 3

_POS = ["love", "great", "happy", "awesome", "best", "amazing", "win",
        "beautiful", "fun", "excited"]
_NEG = ["hate", "terrible", "sad", "awful", "worst", "angry", "lose",
        "ugly", "boring", "disappointed"]
_NEU = ["today", "meeting", "report", "weather", "schedule", "update",
        "news", "city", "game", "event"]
_FILL = ["the", "a", "is", "was", "to", "and", "of", "in", "it", "that",
         "this", "on", "for", "with", "at", "user", "rt", "qt", "so",
         "very", "just", "now", "then", "here", "there"]

VOCAB: List[str] = sorted(set(_POS + _NEG + _NEU + _FILL))
WORD_ID = {w: i for i, w in enumerate(VOCAB)}

# class → (sentiment-lexicon, rate of sentiment words)
_CLASS_LEX = {0: (_NEG, 0.35), 1: (_NEU, 0.30), 2: (_POS, 0.35)}


def generate(n: int, *, seed: int = 0) -> Tuple[List[str], np.ndarray]:
    """Returns (texts, labels (n,) int32)."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, N_CLASSES, size=n).astype(np.int32)
    texts = []
    for y in labels:
        lex, rate = _CLASS_LEX[int(y)]
        length = max(4, int(rng.normal(18, 6)))
        words = []
        for _ in range(length):
            if rng.random() < rate:
                words.append(lex[rng.integers(0, len(lex))])
            else:
                words.append(_FILL[rng.integers(0, len(_FILL))])
        texts.append(" ".join(words))
    return texts, labels


def bag_features(texts: List[str], n_features: int = 4) -> np.ndarray:
    """Sentiment-score features for the 4-qubit QNN encoding: per text,
    [pos_rate, neg_rate, neu_rate, log-length], scaled to [0, π] later."""
    pos, neg, neu = set(_POS), set(_NEG), set(_NEU)
    out = np.zeros((len(texts), 4), np.float32)
    for i, t in enumerate(texts):
        ws = t.split()
        L = max(len(ws), 1)
        out[i, 0] = sum(w in pos for w in ws) / L
        out[i, 1] = sum(w in neg for w in ws) / L
        out[i, 2] = sum(w in neu for w in ws) / L
        out[i, 3] = np.log1p(L) / 4.0
    return out[:, :n_features]
