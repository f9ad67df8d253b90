"""Masked batched SPSA: C clients' SPSA runs advanced together.

The port of ``repro/optim/batched_spsa.py``.  Parameters live on the
device as a ``(C, P)`` stack and every evaluation is one call of the
objective over a candidate stack, ``f : (C, K, P) → (C, K)`` (the
batched Nelder–Mead's interface): the start and the final polish are
``K = 1``, each iteration's ± perturbation pair one ``K = 2`` call and
its candidate another ``K = 1`` call.

Per-client ``maxiter`` budgets are iteration masks: the loop runs
``max(iters)`` times (read on the host once per call), or a static trip
count ``n_steps`` the caller gives (no host read), and client ``c``
stops updating once ``i >= iters[c]``.  Masked iterations still evaluate
``f`` for the whole stack and leave the masked clients bitwise as they
were.

Arithmetic: the JAX package computes the gains ``a_k``, ``c_k`` and the
gradient estimate in float32 inside its ``fori_loop`` (``i + 1.0`` on
the int32 loop index is a float32), not in ``gradfree.spsa_run``'s
float64, and so does this port: the gains are float32 scalars computed
on the host, the rest float32 on the device.

Perturbation signs are drawn on the host by ``make_deltas`` with the
exact ``np.random.default_rng`` call sequence of ``gradfree.spsa_run``,
so a batched round sees the same Rademacher directions as C sequential
runs with seeds ``seeds[c]``.  Finite-shot objectives (``keyed=True``)
are called as ``f(xs, slots)`` with the ``(K,)`` contract slots of
``backends.py``: the start → 0, iteration ``k``'s pair → ``1+3k``,
``2+3k`` and its candidate → ``3+3k``, the final polish →
``FINAL_EVAL_SLOT``: the slots ``gradfree.spsa_run`` hands its
``key_stream``.
"""
from __future__ import annotations

from typing import Callable, Sequence, Tuple

import numpy as np
import torch

from repro_torch.optim.gradfree import spsa_rng
from repro_torch.quantum.backends import FINAL_EVAL_SLOT


def make_deltas(seeds: Sequence[int], max_iter: int, dim: int) -> np.ndarray:
    """(C, max_iter, dim) Rademacher directions, matching the draw order of
    ``gradfree.spsa_run`` (one ``rng.choice([-1,1], size=dim)`` per iter,
    the ``gradfree.spsa_rng(seed, 0)`` stream per client — a fresh run)."""
    out = np.empty((len(seeds), max_iter, dim), np.float64)
    for c, seed in enumerate(seeds):
        rng = spsa_rng(seed, 0)
        for i in range(max_iter):
            out[c, i] = rng.choice([-1.0, 1.0], size=dim)
    return out


def _gains(i: int, a, c, A, alpha, gamma) -> Tuple[float, float]:
    """float32 a_k and c_k of iteration ``i``, as the JAX loop body
    computes them from its int32 index."""
    k1 = np.float32(i) + np.float32(1.0)
    ak = np.float32(a) / (k1 + np.float32(A)) ** np.float32(alpha)
    ck = np.float32(c) / k1 ** np.float32(gamma)
    return float(np.float32(ak)), float(np.float32(ck))


def batched_spsa(f: Callable, x0: torch.Tensor, iters, deltas: torch.Tensor,
                 *, a=0.2, c=0.15, A=10.0, alpha=0.602, gamma=0.101,
                 clip: float = 1.0, keyed: bool = False, active=None,
                 n_steps=None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Masked batched SPSA.

    f      : (C, K, P) → (C, K), the objective over a candidate stack;
             with ``keyed=True`` it is called as ``f(xs, slots)``,
             ``slots`` the ``(K,)`` int64 contract slots
    x0     : (C, P) start (typically θ_g broadcast to all clients)
    iters  : (C,)   per-client iteration budgets (mask, not trip count)
    deltas : (C, M, P) perturbation signs, M ≥ max(iters)
    active : optional (C,) bool participation mask: an inactive client's
             budget is forced to 0 (``x`` returns its start row) and its
             ``n_evals`` is 0.  ``None`` is the all-active behaviour.
    n_steps: optional static trip count in ``[0, M]``, at least every
             client's budget, in place of the host read of ``max(iters)``

    Returns (x (C, P), f_final (C,), n_evals (C,) int32), ``n_evals``
    counting what the sequential path would have spent: 1 init + 3 an
    iteration + 1 final.
    """
    x = x0.float()
    dev = x.device
    iters = torch.as_tensor(iters, dtype=torch.int32, device=dev)
    deltas = torch.as_tensor(deltas, dtype=torch.float32, device=dev)
    if active is not None:
        active = torch.as_tensor(active, dtype=torch.bool, device=dev)
        iters = torch.where(active, iters, 0)

    fstack = f if keyed else (lambda xs, slots: f(xs))

    def call(xs, slot: int):
        return fstack(xs[:, None], np.array([slot]))[:, 0]

    fbest = call(x, 0)
    if n_steps is None:
        n_steps = int(iters.max()) if x.shape[0] else 0
    elif not 0 <= n_steps <= deltas.shape[1]:
        raise ValueError(f"n_steps={n_steps} is outside [0, "
                         f"{deltas.shape[1]}]")
    for i in range(n_steps):
        ak, ck = _gains(i, a, c, A, alpha, gamma)
        d = deltas[:, i, :]                                  # (C, P)
        base = 1 + 3 * i
        fpm = fstack(torch.stack([x + ck * d, x - ck * d], dim=1),
                     np.array([base, base + 1]))                # (C, 2)
        ghat = (fpm[:, 0] - fpm[:, 1])[:, None] / (2.0 * ck) * (1.0 / d)
        if clip:
            gn = torch.sqrt(torch.sum(ghat * ghat, dim=-1, keepdim=True))
            ghat = torch.where(gn > clip, ghat * (clip / gn), ghat)
        cand = x - ak * ghat
        fc = call(cand, base + 2)
        accept = fc <= fbest + torch.abs(fbest) * 0.1 + 1e-3  # blocking step
        upd = accept & (i < iters)
        x = torch.where(upd[:, None], cand, x)
        fbest = torch.where(upd, torch.minimum(fbest, fc), fbest)
    n_evals = (2 + 3 * iters).int()
    if active is not None:
        n_evals = torch.where(active, n_evals, 0).int()
    return x, call(x, FINAL_EVAL_SLOT), n_evals
