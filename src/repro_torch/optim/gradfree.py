"""Gradient-free optimizers with COBYLA-compatible ``maxiter`` semantics.

The port of ``repro/optim/gradfree.py``: numpy in float64, its semantics
unchanged, so the sequential engine's trajectories are the JAX
package's (the objective casts θ to float32 at the device boundary).

The paper drives its quantum models with Qiskit's COBYLA and regulates a
single knob — ``maxiter`` (function-evaluation budget per local round).
COBYLA internals are irrelevant to the contribution (DESIGN.md §6.2); what
matters is a black-box minimizer whose progress is metered in iterations.
We provide:

 - ``NelderMead`` : simplex method (default; deterministic, robust on the
   ≤30-parameter VQC/QCNN landscapes).  One "iteration" = one simplex
   transformation (1–4 function evals), matching scipy/COBYLA's notion of
   a metered step.
 - ``SPSA``       : simultaneous-perturbation stochastic approximation
   (2 evals/iteration), the standard QML alternative.

Both are **resumable**: state in/out, so the federated loop can run
``k`` iterations this round, have the controller re-regulate ``maxiter``,
and continue from the same optimizer state next round — exactly the
paper's regulated-optimizer execution model (Alg. 1 lines 11–17).

Finite-shot objectives take a ``key_stream``: a callable mapping the
evaluation's structural **slot** (the ``backends.py`` key-derivation
contract — init rows, then per-iteration candidate positions) to a PRNG
key, in which case the objective is called as ``fn(x, key)``.  Slots are
derived from the *global* iteration counter (``NMState.n_iters`` /
``SPSAState.k``), so resumed runs keep drawing from fresh slots, and the
batched optimizers (``batched_spsa`` / ``batched_nm``) use the identical
schedule — draw-for-draw parity on noisy backends.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Callable, List, Optional, Tuple

import numpy as np

from repro_torch.quantum.backends import FINAL_EVAL_SLOT


def _call(fn: Callable, x, key_stream, slot: int) -> float:
    """One objective evaluation at its contract slot (keyed or not)."""
    if key_stream is None:
        return float(fn(x))
    return float(fn(x, key_stream(slot)))


# ---------------------------------------------------------------------------
# Nelder–Mead
# ---------------------------------------------------------------------------
@dataclass
class NMState:
    simplex: np.ndarray          # (n+1, n)
    fvals: np.ndarray            # (n+1,)
    n_evals: int = 0
    n_iters: int = 0

    @property
    def best_x(self) -> np.ndarray:
        return self.simplex[int(np.argmin(self.fvals))]

    @property
    def best_f(self) -> float:
        return float(np.min(self.fvals))


def nm_init(fn: Callable, x0: np.ndarray, *, step: float = 0.25,
            key_stream=None) -> NMState:
    x0 = np.asarray(x0, np.float64)
    n = x0.shape[0]
    simplex = np.tile(x0, (n + 1, 1))
    for i in range(n):
        simplex[i + 1, i] += step if x0[i] == 0 else step * abs(x0[i]) + step
    # contract slots 0..n: one per initial simplex row
    fvals = np.array([_call(fn, s, key_stream, r)
                      for r, s in enumerate(simplex)])
    return NMState(simplex, fvals, n_evals=n + 1)


def nm_run(fn: Callable, state: NMState, maxiter: int,
           *, alpha=1.0, gamma=2.0, rho=0.5, sigma=0.5,
           trace: Optional[List[int]] = None, key_stream=None) -> NMState:
    """Run ``maxiter`` simplex iterations from ``state`` (resumable).

    ``trace``, if given, receives one ``batched_nm.BRANCH_*`` code per
    iteration — the decision-parity contract with the batched engine.
    """
    simplex = state.simplex.copy()
    fvals = state.fvals.copy()
    n = simplex.shape[1]
    evals = 0

    for it in range(max(0, int(maxiter))):
        # contract slots for global iteration i: base + {0: reflect,
        # 1: expand, 2: contract, 2+j: shrink row j}
        base = (n + 1) + (state.n_iters + it) * (n + 3)
        # stable sort: ties resolve identically to the batched engine
        order = np.argsort(fvals, kind="stable")
        simplex, fvals = simplex[order], fvals[order]
        centroid = simplex[:-1].mean(axis=0)
        branch = -1

        xr = centroid + alpha * (centroid - simplex[-1])
        fr = _call(fn, xr, key_stream, base); evals += 1
        if fr < fvals[0]:
            xe = centroid + gamma * (xr - centroid)
            fe = _call(fn, xe, key_stream, base + 1); evals += 1
            if fe < fr:
                simplex[-1], fvals[-1] = xe, fe
                branch = 0                      # BRANCH_EXPAND_XE
            else:
                simplex[-1], fvals[-1] = xr, fr
                branch = 1                      # BRANCH_EXPAND_XR
        elif fr < fvals[-2]:
            simplex[-1], fvals[-1] = xr, fr
            branch = 2                          # BRANCH_REFLECT
        else:
            xc = centroid + rho * (simplex[-1] - centroid)
            fc = _call(fn, xc, key_stream, base + 2); evals += 1
            if fc < fvals[-1]:
                simplex[-1], fvals[-1] = xc, fc
                branch = 3                      # BRANCH_CONTRACT
            else:   # shrink
                branch = 4                      # BRANCH_SHRINK
                for i in range(1, n + 1):
                    simplex[i] = simplex[0] + sigma * (simplex[i] - simplex[0])
                    fvals[i] = _call(fn, simplex[i], key_stream, base + 2 + i)
                    evals += 1
        if trace is not None:
            trace.append(branch)

    return NMState(simplex, fvals, state.n_evals + evals,
                   state.n_iters + max(0, int(maxiter)))


# ---------------------------------------------------------------------------
# SPSA
# ---------------------------------------------------------------------------
def spsa_rng(seed: int, k: int) -> np.random.Generator:
    """Rademacher stream for a resumed SPSA run.

    ``default_rng(seed + k)`` would collide across clients: federated
    client seeds are consecutive (``rc.seed·997 + i``), so client ``i``
    resumed at iteration ``k`` would replay client ``i+k``'s fresh stream.
    ``SeedSequence((seed, k))`` hashes the pair, keeping every
    (client, resume-point) stream distinct.  ``batched_spsa.make_deltas``
    derives its draws from this same function — draw-for-draw parity.
    """
    return np.random.default_rng(np.random.SeedSequence((int(seed), int(k))))


@dataclass
class SPSAState:
    x: np.ndarray
    f: float
    k: int = 0                  # global iteration counter (gain schedule)
    n_evals: int = 0
    seed: int = 0

    @property
    def best_x(self) -> np.ndarray:
        return self.x

    @property
    def best_f(self) -> float:
        return float(self.f)


def spsa_init(fn: Callable, x0: np.ndarray, *, seed: int = 0,
              key_stream=None) -> SPSAState:
    x0 = np.asarray(x0, np.float64)
    return SPSAState(x0, _call(fn, x0, key_stream, 0), n_evals=1, seed=seed)


def spsa_run(fn: Callable, state: SPSAState, maxiter: int, *,
             a=0.2, c=0.15, A=10.0, alpha=0.602, gamma=0.101,
             clip: float = 1.0, key_stream=None) -> SPSAState:
    rng = spsa_rng(state.seed, state.k)
    x, fbest, k, evals = state.x.copy(), state.f, state.k, 0
    for _ in range(max(0, int(maxiter))):
        ak = a / (k + 1 + A) ** alpha
        ck = c / (k + 1) ** gamma
        delta = rng.choice([-1.0, 1.0], size=x.shape)
        # contract slots for global iteration k: 1+3k, 2+3k, 3+3k
        fp = _call(fn, x + ck * delta, key_stream, 1 + 3 * k)
        fm = _call(fn, x - ck * delta, key_stream, 2 + 3 * k)
        evals += 2
        ghat = (fp - fm) / (2 * ck) * (1.0 / delta)
        gn = float(np.linalg.norm(ghat))
        if clip and gn > clip:          # norm-clip: stabilizes rough
            ghat = ghat * (clip / gn)   # quantum loss landscapes
        cand = x - ak * ghat
        fc = _call(fn, cand, key_stream, 3 + 3 * k); evals += 1
        if fc <= fbest + abs(fbest) * 0.1 + 1e-3:   # blocking step
            x, fbest = cand, min(fbest, fc)
        k += 1
    return SPSAState(x, _call(fn, x, key_stream, FINAL_EVAL_SLOT), k,
                     state.n_evals + evals + 1, state.seed)


# ---------------------------------------------------------------------------
# unified resumable facade (what core/ uses)
# ---------------------------------------------------------------------------
class GradFreeOptimizer:
    """Resumable metered optimizer.  ``run(maxiter)`` advances the state;
    the controller owns the budget (the paper's regulation law)."""

    def __init__(self, fn: Callable, x0, *, method: str = "nelder-mead",
                 seed: int = 0, key_stream=None):
        self.fn = fn
        self.method = method
        self.key_stream = key_stream
        if method == "nelder-mead":
            self.state = nm_init(fn, np.asarray(x0), key_stream=key_stream)
        elif method == "spsa":
            self.state = spsa_init(fn, np.asarray(x0), seed=seed,
                                   key_stream=key_stream)
        else:
            raise ValueError(method)

    def run(self, maxiter: int) -> Tuple[np.ndarray, float]:
        if self.method == "nelder-mead":
            self.state = nm_run(self.fn, self.state, maxiter,
                                key_stream=self.key_stream)
        else:
            self.state = spsa_run(self.fn, self.state, maxiter,
                                  key_stream=self.key_stream)
        return self.state.best_x, self.state.best_f

    def set_fn(self, fn: Callable):
        """Swap the objective (e.g. distillation weight changed) without
        resetting optimizer geometry.  Keyed objectives re-evaluate on
        the init slots (rows 0..n / slot 0) — a deliberate replay."""
        self.fn = fn
        ks = self.key_stream
        if self.method == "nelder-mead":
            st = self.state
            fvals = np.array([_call(fn, s, ks, r)
                              for r, s in enumerate(st.simplex)])
            self.state = NMState(st.simplex, fvals, st.n_evals + len(fvals),
                                 st.n_iters)
        else:
            st = self.state
            self.state = replace(st, f=_call(fn, st.x, ks, 0),
                                 n_evals=st.n_evals + 1)

    @property
    def n_evals(self) -> int:
        return self.state.n_evals

    @property
    def best(self) -> Tuple[np.ndarray, float]:
        return self.state.best_x, self.state.best_f
