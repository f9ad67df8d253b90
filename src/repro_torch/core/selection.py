"""Alignment-based client selection (Sec. III-B).

d_i^t = |L_i^t − L_s^t|; keep the devices with the smallest k% distances.
Reduces aggregation variance by (1 − k/N) (Cor. VI.8.2).
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np


def distances(client_losses: Sequence[float], server_loss: float
              ) -> np.ndarray:
    """|L_i − L_s| with non-finite entries mapped to +inf: a diverged
    client (NaN/inf local loss) is maximally misaligned — it sorts last
    in selection and never contaminates downstream statistics with NaN
    (NaN would also break ``argsort``'s ordering guarantees)."""
    with np.errstate(invalid="ignore"):
        d = np.abs(np.asarray(client_losses, np.float64) - server_loss)
    return np.where(np.isfinite(d), d, np.inf)


def select_aligned(client_losses: Sequence[float], server_loss: float,
                   frac: float) -> List[int]:
    """Indices of the top-k% most aligned clients (ties → lower index).
    Always returns at least one client; diverged clients sort last."""
    d = distances(client_losses, server_loss)
    k = max(1, int(round(frac * len(d))))
    return sorted(np.argsort(d, kind="stable")[:k].tolist())


def selection_variance(client_losses: Sequence[float], server_loss: float,
                       selected: Sequence[int]) -> dict:
    """Empirical check of Cor. VI.8.2: Var over selected ≤ Var over all.

    Variances are taken over the *finite* distances only, so one
    diverged client does not turn every ``RoundRecord``'s ``var_all``
    into NaN; 0.0 when no finite entries remain.
    """
    d = distances(client_losses, server_loss)
    d2 = d ** 2

    def _var(v: np.ndarray) -> float:
        v = v[np.isfinite(v)]
        return float(v.mean()) if v.size else 0.0

    return {"var_all": _var(d2),
            "var_selected": _var(d2[list(selected)])}
