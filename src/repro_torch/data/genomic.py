"""Synthetic DemoHumanOrWorm generator (DESIGN.md §2).

The real dataset (genomic-benchmarks, 75k train / 25k test) is a binary
classification of 200-nucleotide sequences: Human (0) vs Worm (1).  Offline
we generate a *learnable* surrogate with the same shapes/cardinalities:
class-conditional base composition (human ~41% GC, worm ~36% GC) plus
class-specific planted motifs at random offsets — recoverable by both the
k-mer LLM path and the PCA→4-qubit quantum path.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np

NUCLEOTIDES = "ACGT"
NUCLEOTIDE_MAP = {"A": 0, "C": 1, "G": 2, "T": 3}   # paper Sec. IV Exp. I
SEQ_LEN = 200

# class-specific motifs (planted signal)
_MOTIFS = {0: ["TATAAA", "GGCCGG", "CCGCCC"],        # human-like
           1: ["TTGATA", "AATTTT", "GATAAG"]}        # worm-like
_GC = {0: 0.41, 1: 0.36}


def generate(n: int, *, seed: int = 0, motif_rate: float = 0.9
             ) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (sequences (n, 200) int8 in {0..3}, labels (n,) int32)."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 2, size=n).astype(np.int32)
    seqs = np.empty((n, SEQ_LEN), np.int8)
    for cls in (0, 1):
        idx = np.where(labels == cls)[0]
        gc = _GC[cls]
        # base distribution over A,C,G,T
        p = np.array([(1 - gc) / 2, gc / 2, gc / 2, (1 - gc) / 2])
        seqs[idx] = rng.choice(4, size=(len(idx), SEQ_LEN), p=p)
        # plant motifs
        for i in idx:
            if rng.random() < motif_rate:
                for m in _MOTIFS[cls]:
                    if rng.random() < 0.7:
                        enc = np.array([NUCLEOTIDE_MAP[c] for c in m],
                                       np.int8)
                        off = rng.integers(0, SEQ_LEN - len(enc))
                        seqs[i, off:off + len(enc)] = enc
    return seqs, labels


def one_hot(seqs: np.ndarray) -> np.ndarray:
    """(n, 200) int → (n, 800) float32 one-hot (A=[1,0,0,0], ... App. B.3)."""
    n, L = seqs.shape
    out = np.zeros((n, L, 4), np.float32)
    out[np.arange(n)[:, None], np.arange(L)[None, :], seqs] = 1.0
    return out.reshape(n, L * 4)


def to_text(seqs: np.ndarray) -> list:
    """int sequences → 'ACGT' strings (LLM tokenization input)."""
    lut = np.array(list(NUCLEOTIDES))
    return ["".join(lut[s]) for s in seqs]
