"""Knowledge distillation term K(θ_g, θ_i) (Eq. 5–6).

The port of ``repro/core/distill.py``.  The fine-tuned local LLM
produces per-example soft class distributions on the client's shard
(teacher).  The client objective adds λ·KL(teacher ‖ student) +
µ·‖θ − θ_g‖², so the gradient-free optimizer minimizes
F_i(θ) + λ·K + µ·prox: local adaptation, global coherence and smooth
convergence, the three forces of Eq. (6).
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch


def kl_divergence(p_teacher: torch.Tensor, p_student: torch.Tensor,
                  eps: float = 1e-9) -> torch.Tensor:
    """Mean KL(p_t ‖ p_s) over the batch; both (B, C) prob simplexes."""
    pt = torch.clamp(p_teacher, eps, 1.0)
    ps = torch.clamp(p_student, eps, 1.0)
    return torch.mean(torch.sum(pt * (torch.log(pt) - torch.log(ps)), -1))


def make_client_objective(qnn_loss_fn: Callable, qnn_forward: Callable,
                          qX: torch.Tensor,
                          teacher_probs: Optional[torch.Tensor],
                          theta_g: Optional[np.ndarray], *,
                          lam: float = 0.1, mu: float = 0.01,
                          keyed: bool = False) -> Callable:
    """theta (np) → float:  F_i + λ·KL(teacher‖student) + µ·‖θ−θ_g‖²/d,
    evaluated on the device of ``qX``.

    ``keyed=True`` when ``qnn_loss_fn`` is a finite-shot loss (called as
    ``fn(theta, key)``); the key feeds only F_i — the KL penalty reads
    the raw student probabilities, as the batched engine's objective
    does.  Each evaluation reads F_i and the penalties back to the host
    separately, as the JAX package does.
    """
    dev = qX.device
    tg = (None if theta_g is None else
          torch.as_tensor(np.asarray(theta_g, np.float32), device=dev))

    def _penalties(theta):
        out = torch.zeros((), dtype=torch.float32, device=dev)
        if teacher_probs is not None and lam > 0:
            probs = qnn_forward(theta, qX)
            out = out + lam * kl_divergence(teacher_probs, probs)
        if tg is not None and mu > 0:
            out = out + mu * torch.mean((theta - tg) ** 2)
        return out

    def _theta(theta_np) -> torch.Tensor:
        return torch.as_tensor(np.asarray(theta_np, np.float32), device=dev)

    if keyed:
        def objective_keyed(theta_np, key) -> float:
            theta = _theta(theta_np)
            return float(qnn_loss_fn(theta, key)) + float(_penalties(theta))

        return objective_keyed

    def objective(theta_np) -> float:
        theta = _theta(theta_np)
        return float(qnn_loss_fn(theta)) + float(_penalties(theta))

    return objective
