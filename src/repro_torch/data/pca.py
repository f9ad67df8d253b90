"""PCA dimensionality reduction (App. B.3 step 4): 800-dim one-hot genomic
features → n_components=4 → scaled to [0, π] for 4-qubit angle encoding."""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class PCA:
    components: np.ndarray        # (d, k)
    mean: np.ndarray              # (d,)
    lo: np.ndarray = None         # per-dim min (for [0,π] rescale)
    hi: np.ndarray = None

    def transform(self, X: np.ndarray) -> np.ndarray:
        Z = (X - self.mean) @ self.components
        if self.lo is not None:
            Z = (Z - self.lo) / np.maximum(self.hi - self.lo, 1e-9)
            Z = np.clip(Z, 0.0, 1.0) * np.pi
        return Z.astype(np.float32)


def fit(X: np.ndarray, n_components: int = 4, *, scale_to_pi: bool = True
        ) -> PCA:
    mean = X.mean(axis=0)
    Xc = X - mean
    # economy SVD — d can be 800, n in the tens of thousands
    _, _, vt = np.linalg.svd(Xc, full_matrices=False)
    comp = vt[:n_components].T
    p = PCA(comp, mean)
    if scale_to_pi:
        Z = Xc @ comp
        p.lo, p.hi = Z.min(axis=0), Z.max(axis=0)
    return p
