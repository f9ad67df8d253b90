"""Optimizer regulation — the paper's "LLM as smart controller" law.

Base law (Sec. III-B):   Regulated_Iter = iter · (L_i^t / L_LLM^t)
applied only when the quantum model underperforms the LLM benchmark
(Alg. 1 line 12: ``if LLM_l < QNN_l``).

App. F variants (Fig. 20): incremental / adaptive / logarithmic /
dynamic-weighted.  All return an integer in [min_iter, cap].
"""
from __future__ import annotations

import math

VARIANTS = ("adaptive", "incremental", "logarithmic", "dynamic")


def regulate(maxiter: int, qnn_loss: float, llm_loss: float, *,
             variant: str = "adaptive", cap: int = 100, min_iter: int = 1,
             weight: float = 0.5, increment: int = 2) -> int:
    """New maxiter given the device's latest loss vs the LLM reference."""
    if llm_loss <= 0 or not math.isfinite(llm_loss):
        return maxiter
    if not math.isfinite(qnn_loss):        # diverged client (NaN/inf loss):
        return max(min_iter, min(maxiter, cap))   # hold the current budget
    if qnn_loss <= llm_loss:               # Alg. 1: only boost when behind
        return max(min_iter, min(maxiter, cap))
    ratio = qnn_loss / llm_loss

    if variant == "adaptive":              # ratio * maxiter (paper default)
        new = maxiter * ratio
    elif variant == "incremental":         # gradual fixed-size increments
        new = maxiter + increment * min(math.ceil(ratio), 5)
    elif variant == "logarithmic":         # damped for large ratios
        new = maxiter * (1.0 + math.log(ratio))
    elif variant == "dynamic":             # weighted blend with current
        new = (1 - weight) * maxiter + weight * maxiter * ratio
    else:
        raise ValueError(f"unknown variant {variant!r}; one of {VARIANTS}")
    return int(max(min_iter, min(round(new), cap)))
