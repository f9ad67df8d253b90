"""Federated data partitioning: IID and Dirichlet non-IID client splits."""
from __future__ import annotations

from typing import Dict, List

import numpy as np


def split_iid(n: int, n_clients: int, *, seed: int = 0) -> List[np.ndarray]:
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    return [np.sort(s) for s in np.array_split(perm, n_clients)]


def split_dirichlet(labels: np.ndarray, n_clients: int, *,
                    alpha: float = 0.5, seed: int = 0,
                    min_per_client: int = 8) -> List[np.ndarray]:
    """Label-skew non-IID partition: per class, proportions ~ Dir(alpha)."""
    rng = np.random.default_rng(seed)
    labels = np.asarray(labels)
    classes = np.unique(labels)
    shards: List[List[int]] = [[] for _ in range(n_clients)]
    for c in classes:
        idx = np.where(labels == c)[0]
        rng.shuffle(idx)
        props = rng.dirichlet(np.full(n_clients, alpha))
        cuts = (np.cumsum(props) * len(idx)).astype(int)[:-1]
        for shard, part in zip(shards, np.split(idx, cuts)):
            shard.extend(part.tolist())
    # rebalance clients that got starved
    sizes = np.array([len(s) for s in shards])
    while sizes.min() < min_per_client:
        src, dst = int(np.argmax(sizes)), int(np.argmin(sizes))
        shards[dst].append(shards[src].pop())
        sizes = np.array([len(s) for s in shards])
    return [np.sort(np.array(s)) for s in shards]


def client_weights(shards: List[np.ndarray]) -> np.ndarray:
    """w_i = |D_i| / |D| (Eq. 2)."""
    sizes = np.array([len(s) for s in shards], np.float64)
    return sizes / sizes.sum()
