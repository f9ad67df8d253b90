"""Early-termination criterion (Sec. III-B):
stop when ΔL_s^t / L_s^t < ε or t ≥ T_max."""
from __future__ import annotations

from typing import List, Optional


class TerminationCriterion:
    def __init__(self, *, epsilon: float = 1e-3, t_max: int = 100,
                 patience: int = 1):
        self.epsilon = epsilon
        self.t_max = t_max
        self.patience = patience          # consecutive small-improvements
        self._history: List[float] = []
        self._small = 0

    def update(self, server_loss: float, t: int) -> bool:
        """Record round-t server loss; True → stop."""
        h = self._history
        h.append(float(server_loss))
        if t >= self.t_max:
            return True
        if len(h) >= 2:
            if abs(h[-1]) > 0:
                rel = abs(h[-1] - h[-2]) / abs(h[-1])
            else:
                # loss hit exactly 0: a zero-loss plateau (Δ = 0) is
                # converged; a fresh drop to 0 still counts as progress
                rel = 0.0 if h[-2] == h[-1] else float("inf")
            self._small = self._small + 1 if rel < self.epsilon else 0
            if self._small >= self.patience:
                return True
        return False

    @property
    def history(self) -> List[float]:
        return list(self._history)
