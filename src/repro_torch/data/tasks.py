"""Task assembly: dataset → (quantum features, LLM token batches) per client.

Experiment I  (paper Sec. IV): genomic + VQC + LLaMA-3.2-1B-LoRA.
Experiment II (paper Sec. IV): tweets  + QCNN + GPT-2 / DeepSeek-7B.

``build_task`` returns a ``FederatedTask`` holding per-client shards in both
representations, plus held-out test/val splits — everything ``repro_torch.core``
needs to run Algorithm 1.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from repro_torch.data import federated, genomic, pca as pca_mod, tokenizer, tweets


@dataclass
class ClientShard:
    qX: np.ndarray               # (n_i, n_features) angle feats in [0, π]
    qy: np.ndarray               # (n_i,)
    llm_batch: Dict[str, np.ndarray]     # tokens/labels for LoRA fine-tune
    n: int = 0

    def __post_init__(self):
        self.n = len(self.qy)


@dataclass
class FederatedTask:
    name: str                    # "genomic" | "tweets"
    n_classes: int
    clients: List[ClientShard]
    test_qX: np.ndarray
    test_qy: np.ndarray
    val_qX: np.ndarray
    val_qy: np.ndarray
    vocab_size: int
    llm_seq_len: int
    weights: np.ndarray = field(default=None)

    @property
    def n_clients(self) -> int:
        return len(self.clients)


def build_task(name: str, *, n_clients: int = 5, train_size: int = 1000,
               test_size: int = 200, val_size: int = 100,
               non_iid_alpha: float = 0.0, seed: int = 0,
               llm_seq_len: int = 64, n_features: int = 4) -> FederatedTask:
    if name == "genomic":
        seqs, labels = genomic.generate(train_size + test_size + val_size,
                                        seed=seed)
        feats = genomic.one_hot(seqs)
        texts = genomic.to_text(seqs)
        tok = tokenizer.KmerTokenizer(k=6, n_labels=2)
        token_lists = [tok.encode(t) for t in texts]
        n_classes = 2
    elif name == "tweets":
        texts, labels = tweets.generate(train_size + test_size + val_size,
                                        seed=seed)
        feats = tweets.bag_features(texts, n_features=n_features)
        tok = tokenizer.WordTokenizer(tweets.VOCAB, n_labels=3)
        token_lists = [tok.encode(t) for t in texts]
        n_classes = 3
    else:
        raise ValueError(name)

    tr = slice(0, train_size)
    te = slice(train_size, train_size + test_size)
    va = slice(train_size + test_size, train_size + test_size + val_size)

    # PCA(n_features) fit on train only, angle-scaled to [0, π];
    # n_features = n_qubits of the QNN that will consume the task
    p = pca_mod.fit(feats[tr], n_components=n_features)
    qX = p.transform(feats)
    if qX.shape[1] != n_features:
        # bag_features caps at its lexicon scores; PCA caps at data rank
        raise ValueError(
            f"task {name!r} can only encode {qX.shape[1]} features "
            f"(requested n_features={n_features})")

    if non_iid_alpha > 0:
        shards = federated.split_dirichlet(labels[tr], n_clients,
                                           alpha=non_iid_alpha, seed=seed)
    else:
        shards = federated.split_iid(train_size, n_clients, seed=seed)

    packed = tokenizer.pack_classification(token_lists, labels, tok,
                                           max_len=llm_seq_len)
    clients = []
    for idx in shards:
        clients.append(ClientShard(
            qX=qX[tr][idx], qy=labels[tr][idx],
            llm_batch={"tokens": packed["tokens"][tr][idx],
                       "labels": packed["labels"][tr][idx]}))

    task = FederatedTask(
        name=name, n_classes=n_classes, clients=clients,
        test_qX=qX[te], test_qy=labels[te],
        val_qX=qX[va], val_qy=labels[va],
        vocab_size=tok.vocab_size, llm_seq_len=llm_seq_len)
    task.weights = federated.client_weights(shards)
    return task
