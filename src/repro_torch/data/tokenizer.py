"""Tokenizers for the LLM fine-tuning path.

 - ``KmerTokenizer`` : k-mer (k=6 default) tokenization of nucleotide
   strings — the paper's genomic preprocessing (App. B.3 step 3).
 - ``WordTokenizer`` : whitespace word-level tokenizer for tweets.

Both reserve ids: 0=PAD, 1=BOS, 2=EOS, 3=UNK, and a contiguous block of
**label tokens** at the top of the vocab so classification is cast as
next-token prediction (the causal-LM-native form of "sequence
classification with 2 labels").
"""
from __future__ import annotations

import itertools
from typing import Iterable, List, Sequence

import numpy as np

PAD, BOS, EOS, UNK = 0, 1, 2, 3
_SPECIALS = 4


class KmerTokenizer:
    def __init__(self, k: int = 6, n_labels: int = 2, stride: int = None):
        self.k = k
        self.stride = stride or k
        self.n_labels = n_labels
        # full 4^k k-mer vocab (4096 for k=6), deterministic order
        kmers = ["".join(p) for p in itertools.product("ACGT", repeat=k)]
        self._kmer_id = {m: _SPECIALS + i for i, m in enumerate(kmers)}
        self.vocab_size = _SPECIALS + len(kmers) + n_labels

    def label_token(self, label: int) -> int:
        return self.vocab_size - self.n_labels + int(label)

    def encode(self, seq: str) -> List[int]:
        ids = [BOS]
        for i in range(0, len(seq) - self.k + 1, self.stride):
            ids.append(self._kmer_id.get(seq[i:i + self.k], UNK))
        return ids


class WordTokenizer:
    def __init__(self, vocab: Sequence[str], n_labels: int = 3):
        self.n_labels = n_labels
        self._word_id = {w: _SPECIALS + i for i, w in enumerate(vocab)}
        self.vocab_size = _SPECIALS + len(vocab) + n_labels

    def label_token(self, label: int) -> int:
        return self.vocab_size - self.n_labels + int(label)

    def encode(self, text: str) -> List[int]:
        return [BOS] + [self._word_id.get(w, UNK) for w in text.split()]


def pack_classification(token_lists: Iterable[List[int]],
                        labels: np.ndarray, tok, max_len: int
                        ) -> dict:
    """Build (tokens, labels) arrays for causal-LM classification:
    sequence + label-token appended; CE mask everywhere except the label
    position (labels=-1 masked by ``chunked_ce``)."""
    labels = np.asarray(labels)
    n = len(labels)
    toks = np.full((n, max_len), PAD, np.int32)
    ys = np.full((n, max_len), -1, np.int32)
    for i, ids in enumerate(token_lists):
        ids = list(ids)[: max_len - 1]
        toks[i, : len(ids)] = ids
        # the model must predict the label token after the sequence
        ys[i, len(ids) - 1] = tok.label_token(int(labels[i]))
        if len(ids) < max_len:          # teacher-forced label position
            toks[i, len(ids)] = tok.label_token(int(labels[i]))
    return {"tokens": toks, "labels": ys}
