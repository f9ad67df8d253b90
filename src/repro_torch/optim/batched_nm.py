"""Masked batched Nelder–Mead: C simplexes advanced together.

The port of ``repro/optim/batched_nm.py``.  Every candidate point of one
simplex iteration depends only on the current simplex, so reflect,
expand, contract and the ``n`` shrink points are evaluated
**speculatively** as one dense ``(C, n+3, P)`` batch, and the branch the
sequential method would have taken is selected per client with masks.
Per-client ``maxiter`` budgets are an iteration mask: the loop runs
``min(max(iters), max_iter)`` times (read on the host once per call), or
a static trip count ``n_steps`` the caller gives (no host read: the
fused round loop passes ``max_iter``), and a client past its budget
keeps its simplex, so any trip count from ``max(iters)`` up gives the
same bits.  An ``active`` mask forces a client's budget to 0.

Eval accounting follows the branch actually taken (expand 2, reflect 1,
contract 2, shrink 2+n) so ``n_evals`` matches the sequential method
eval for eval, and the branch of every iteration is recorded in a
``(C, max_iter)`` code array (``BRANCH_*``).  Sorting is stable, as
``jnp.argsort`` is: ties in ``fvals`` do occur.

Finite-shot objectives (``keyed=True``) are called as ``f(xs, slots)``
with the ``(K,)`` contract slots of the candidates (``backends.py``):
init row ``r`` → slot ``r``; iteration ``i``'s candidates ``[xr, xe,
xc, shrink 1..n]`` → ``base..base+n+2`` with ``base = (n+1) + i·(n+3)``.
A candidate owns its slot whether its branch is taken or not, so the
draws of every candidate the sequential ``gradfree.nm_run`` evaluates
lazily are the ones evaluated here.  The slots are host integers: the
keyed objective derives its keys without reading the device.
"""
from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

# branch codes, aligned with the JAX package's gradfree.nm_run(trace=...)
BRANCH_EXPAND_XE = 0      # fr < f_best, fe < fr  → worst ← xe   (2 evals)
BRANCH_EXPAND_XR = 1      # fr < f_best, fe ≥ fr  → worst ← xr   (2 evals)
BRANCH_REFLECT = 2        # f_best ≤ fr < f_2nd   → worst ← xr   (1 eval)
BRANCH_CONTRACT = 3       # fc < f_worst          → worst ← xc   (2 evals)
BRANCH_SHRINK = 4         # rows 1..n shrink toward best      (2+n evals)
BRANCH_INACTIVE = -1      # iteration ≥ the client's regulated budget


def init_simplexes(x0: torch.Tensor, *, step: float = 0.25) -> torch.Tensor:
    """(C, P) starts → (C, P+1, P) simplex stacks, the ``nm_init`` rule:
    row i+1 offsets coordinate i by ``step`` (or ``step·|x|+step``)."""
    x0 = x0.float()
    n = x0.shape[-1]
    offset = torch.where(x0 == 0, step, step * torch.abs(x0) + step)
    basis = torch.eye(n + 1, n, device=x0.device).roll(1, 0)  # row 0 zero
    return x0[:, None, :] + basis[None] * offset[:, None, :]


def batched_nm(f: Callable, x0: torch.Tensor, iters, max_iter: int, *,
               alpha=1.0, gamma=2.0, rho=0.5, sigma=0.5, step: float = 0.25,
               keyed: bool = False, active=None, n_steps=None
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                          torch.Tensor]:
    """Masked batched Nelder–Mead.

    f        : (C, K, P) → (C, K), the objective over a candidate stack;
               with ``keyed=True`` it is called as ``f(xs, slots)``,
               ``slots`` the ``(K,)`` int64 contract slots
    x0       : (C, P) start (typically θ_g broadcast to all clients)
    iters    : (C,)   per-client iteration budgets (mask, not trip count)
    max_iter : upper bound on any budget (branch-record width)
    active   : optional (C,) bool participation mask: an inactive
               client's budget is forced to 0 (its simplex stays the init
               simplex, its branch row ``BRANCH_INACTIVE``) and its
               ``n_evals``, init included, is 0.  ``None`` is the
               all-active behaviour.
    n_steps  : optional static trip count in ``[0, max_iter]``, at least
               every client's budget, in place of the host read of
               ``max(iters)``

    Returns ``(simplex (C, n+1, P), fvals (C, n+1), n_evals (C,) int32,
    branches (C, max_iter) int32)``.  The best point is
    ``simplex[c, argmin(fvals[c])]``.
    """
    x0 = x0.float()
    dev = x0.device
    C, n = x0.shape
    iters = torch.as_tensor(iters, dtype=torch.int32, device=dev)
    if active is not None:
        active = torch.as_tensor(active, dtype=torch.bool, device=dev)
        iters = torch.where(active, iters, 0)
    fstack = f if keyed else (lambda xs, slots: f(xs))

    simplex = init_simplexes(x0, step=step)
    fvals = fstack(simplex, np.arange(n + 1))                # (C, n+1)
    evals = torch.full((C,), n + 1, dtype=torch.int32, device=dev)
    if active is not None:
        evals = torch.where(active, evals, 0)
    branches = torch.full((C, int(max_iter)), BRANCH_INACTIVE,
                          dtype=torch.int32, device=dev)

    if n_steps is None:
        n_steps = min(int(iters.max()) if C else 0, int(max_iter))
    elif not 0 <= n_steps <= max_iter:
        raise ValueError(f"n_steps={n_steps} is outside [0, {max_iter}]")
    for i in range(n_steps):
        order = torch.argsort(fvals, dim=1, stable=True)
        sx = torch.gather(simplex, 1, order[:, :, None].expand(-1, -1, n))
        sf = torch.gather(fvals, 1, order)
        best, worst = sx[:, 0, :], sx[:, -1, :]
        f_best, f_2nd, f_worst = sf[:, 0], sf[:, -2], sf[:, -1]
        centroid = torch.mean(sx[:, :-1, :], dim=1)          # (C, P)

        xr = centroid + alpha * (centroid - worst)
        xe = centroid + gamma * (xr - centroid)
        xc = centroid + rho * (worst - centroid)
        shrink_x = best[:, None, :] + sigma * (sx[:, 1:, :] - best[:, None, :])
        cand = torch.cat([torch.stack([xr, xe, xc], dim=1), shrink_x], 1)
        slots = (n + 1) + i * (n + 3) + np.arange(n + 3)
        fcand = fstack(cand, slots)                          # (C, n+3)
        fr, fe, fc = fcand[:, 0], fcand[:, 1], fcand[:, 2]
        f_shrink = fcand[:, 3:]

        # the sequential branch ladder, as per-client masks
        expand = fr < f_best
        take_xe = expand & (fe < fr)
        reflect = ~expand & (fr < f_2nd)
        contract = ~expand & ~reflect & (fc < f_worst)
        shrink = ~expand & ~reflect & ~contract

        use_xr = (expand & ~take_xe) | reflect
        new_worst_x = torch.where(take_xe[:, None], xe,
                                  torch.where(use_xr[:, None], xr, xc))
        new_worst_f = torch.where(take_xe, fe, torch.where(use_xr, fr, fc))
        repl_x = torch.cat([sx[:, :-1, :], new_worst_x[:, None, :]], 1)
        repl_f = torch.cat([sf[:, :-1], new_worst_f[:, None]], 1)
        shr_x = torch.cat([sx[:, :1, :], shrink_x], 1)
        shr_f = torch.cat([sf[:, :1], f_shrink], 1)
        upd_x = torch.where(shrink[:, None, None], shr_x, repl_x)
        upd_f = torch.where(shrink[:, None], shr_f, repl_f)

        live = i < iters
        simplex = torch.where(live[:, None, None], upd_x, simplex)
        fvals = torch.where(live[:, None], upd_f, fvals)
        spent = torch.where(reflect, 1, torch.where(shrink, 2 + n, 2))
        evals = evals + torch.where(live, spent, 0).int()
        code = torch.where(
            take_xe, BRANCH_EXPAND_XE,
            torch.where(expand, BRANCH_EXPAND_XR,
                        torch.where(reflect, BRANCH_REFLECT,
                                    torch.where(contract, BRANCH_CONTRACT,
                                                BRANCH_SHRINK))))
        branches[:, i] = torch.where(live, code, BRANCH_INACTIVE).int()
    return simplex, fvals, evals, branches


def best_point(simplex: torch.Tensor, fvals: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-client incumbent: (x (C, P), f (C,)) at ``argmin(fvals)``."""
    idx = torch.argmin(fvals, dim=1)
    rows = torch.arange(simplex.shape[0], device=simplex.device)
    return simplex[rows, idx], fvals[rows, idx]
