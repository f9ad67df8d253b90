"""Quantum execution backends: ideal / noisy simulators / emulated QPU.

The port of ``repro/quantum/backends.py``:
 - exact:    statevector probabilities (AerSimulator, noise-free)
 - aersim:   depolarizing + readout bit-flip noise (AerSimulator with
             the IBM_Brisbane noise model)
 - fake:     FakeManila-style snapshot (stronger readout error)
 - real:     aersim's noise plus queue/latency emulation for the
             communication-time accounting of Table I

Each backend transforms *class probabilities* in two stages, a
deterministic noise channel (``apply_channel``) and keyed finite-shot
sampling (``sample``), and reports a wall-time estimate per evaluation
batch (``eval_time``).

Key-derivation contract (the JAX package's, draw for draw)
----------------------------------------------------------
Every finite-shot evaluation draws its shots from

    ``eval_key(PRNGKey(seed), round, client, slot)``
    = ``fold_in(fold_in(fold_in(PRNGKey(seed), round), client), slot)``

where ``slot`` is the evaluation's structural position in the round's
schedule (Nelder–Mead: init row ``r`` → ``r``, iteration ``i``'s
reflect/expand/contract/shrink ``j`` → ``(n+1) + i·(n+3) + {0, 1, 2,
2+j}``; SPSA: 0, ``1+3k``, ``2+3k``, ``3+3k``, ``FINAL_EVAL_SLOT``), so
the batched engine's speculative candidates and the sequential engine's
lazy evaluations share keys.  The orchestrator's reports use
``REPORT_EVAL_SLOT`` on the client's stream and the server's evaluations
the reserved ``SERVER_CLIENT`` with slots ``SERVER_SLOT_*``.

Keys are numpy ``(2,)`` arrays (``repro_torch.random``), or stacks
``(..., 2)``: ``sample_counts`` takes one key a ``(B, C)`` block and
draws every block of a stack in one pass on the device.  A stack may
also be a tensor on the device already (int32 words holding the keys'
bits), as the fused round loop stages its whole run's keys once.
``transform_probs`` raises ``ValueError`` when ``shots > 0`` and no key
is given: channel-only evaluation is an explicit ``apply_channel``.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch import random as jr

FINAL_EVAL_SLOT = 0x7FFFFFFF      # SPSA's post-loop polish evaluation
REPORT_EVAL_SLOT = 0x7FFFFFFE     # orchestrator per-client loss report
DROPOUT_EVAL_SLOT = 0x7FFFFFFD    # per-round dropout coin (fused loop)
SERVER_CLIENT = 0x7FFFFFFF        # server-side evals
POP_CLIENT = 0x7FFFFFFD           # population cohort draws (fused loop)
POP_SLOT_COHORT = 0
SERVER_SLOT_LOSS_PRE = 0          # server loss of θ_g before aggregation
SERVER_SLOT_LOSS_POST = 1         # server loss after aggregation
SERVER_SLOT_VAL_ACC = 2
SERVER_SLOT_TEST_ACC = 3



def eval_key(base_key: np.ndarray, round_idx, client, slot) -> np.ndarray:
    """The contract's key chain; each integer may be a numpy array, and
    the keys then broadcast (``random.fold_in``)."""
    k = jr.fold_in(base_key, round_idx)
    k = jr.fold_in(k, client)
    return jr.fold_in(k, slot)


@dataclass(frozen=True)
class Backend:
    name: str
    depolarizing: float = 0.0     # prob of replacing output by uniform
    readout_flip: float = 0.0     # per-class confusion strength
    shots: int = 0                # 0 = exact probabilities
    # latency model (seconds) — calibrated to Table I comm-time ratios
    t_per_job: float = 0.0        # fixed overhead per optimizer evaluation
    t_per_shot: float = 0.0
    t_queue: float = 0.0          # QPU queue wait per job

    def apply_channel(self, probs: torch.Tensor) -> torch.Tensor:
        """Deterministic noise channel on (..., C) class probabilities."""
        C = probs.shape[-1]
        # scalars rounded to the probabilities' dtype first, as JAX
        # rounds its weakly typed Python floats (bfloat16 included)
        cast = lambda v: torch.tensor(v, dtype=probs.dtype)  # noqa: E731
        if self.depolarizing:
            probs = cast(1 - self.depolarizing) * probs \
                + cast(self.depolarizing / C)
        if self.readout_flip:
            # symmetric confusion: stay w.p. 1-f, uniform flip otherwise
            f = self.readout_flip
            eye = torch.eye(C, device=probs.device)
            conf = ((1 - f) * eye + f / (C - 1) * (1 - eye)).to(probs.dtype)
            if probs.dtype in (torch.float32, torch.float64):
                probs = probs @ conf
            else:   # a low-precision dot summed in float32, rounded once
                probs = (probs.float() @ conf.float()).to(probs.dtype)
        return probs

    def sample(self, probs: torch.Tensor, key) -> torch.Tensor:
        """Finite-shot readout: empirical frequencies of ``shots`` draws
        a row.  Identity when ``shots == 0``."""
        if not self.shots:
            return probs
        counts = sample_counts(key, probs, self.shots)
        # the reciprocal rounded to the counts' dtype, then one multiply,
        # as the JAX package's weakly typed ``counts * (1.0 / shots)``
        # (a 0-d host tensor: a scalar operand, no copy to the card)
        return counts * torch.tensor(1.0 / self.shots, dtype=counts.dtype)

    def transform_probs(self, probs: torch.Tensor,
                        key: Optional[np.ndarray] = None) -> torch.Tensor:
        """Channel + finite-shot sampling on ``(B, C)`` class
        probabilities under one key, or on ``(..., B, C)`` under a key
        stack ``(..., 2)``.

        Raises when ``shots > 0`` and no key is given: a finite-shot
        backend must never fall back to the deterministic channel."""
        probs = self.apply_channel(probs)
        if self.shots:
            if key is None:
                raise ValueError(
                    f"backend {self.name!r} has shots={self.shots} but "
                    "transform_probs was called without a PRNG key; pass "
                    "an eval_key(...) or use apply_channel() for "
                    "channel-only evaluation")
            probs = self.sample(probs, key)
        return probs

    def eval_time(self, n_circuits: int) -> float:
        """Estimated wall-time for one optimizer evaluation over a batch."""
        return (self.t_queue + self.t_per_job
                + self.t_per_shot * max(self.shots, 1) * n_circuits)


class NearDraws(NamedTuple):
    """Two recorded runs of the same draws compared near the boundaries
    (``DrawMargin.near_disagreements``)."""
    checked: int       # draws within NEAR of a boundary in either run
    flipped: int       # of them, in another class in each run
    unexplained: int   # missing from one run, boundaries more than NEAR
                       # apart, or a flip the boundaries do not straddle
    shift: float       # the largest boundary shift between the runs


class DrawMargin:
    """The smallest distance between a finite-shot draw and an interior
    CDF boundary over every ``sample_counts`` call while tracking is on,
    and the number of draws within ``NEAR`` of one.

    A draw closer to a boundary than two implementations' CDFs differ
    (float noise, about 2e-7) may land in another class in each, so
    whole-run parity at a pinned seed rests on the draws that decide
    the run lying farther than that.  Over a whole run, millions of
    uniform draws put a few within ``NEAR`` by chance (at most 2·NEAR of
    the draw-boundary pairs), so two checks stand in for a margin held
    above ``NEAR``: the near count stays within its chance rate
    (``chance_bound``), and with ``record`` two runs of the same draws
    are compared draw by draw near the boundaries
    (``near_disagreements``).  The minimum and the count stay on the
    device of the draws until they are read; ``record`` reads the size
    of each call's near set, one host synchronisation a call."""

    NEAR = 1e-6

    def __init__(self, record: bool = False):
        self.on = False
        self.record = record
        self._min, self._near, self.draws, self.pairs = None, 0, 0, 0
        self.calls = 0
        self.records = []

    def update(self, u: torch.Tensor, cdf: torch.Tensor,
               skip: torch.Tensor, draws: torch.Tensor):
        """u ``(N, shots, B)``, cdf ``(N, B, C)``, skip ``(N, B)``, the
        classes drawn ``(N, B, shots)``."""
        C = cdf.shape[-1]
        if C < 2:
            return
        # float32: near a boundary the difference is exact (Sterbenz)
        sd = u[..., None].float() - cdf[:, None, :, :C - 1].float()
        d, nearest = sd.abs().min(-1)
        d = torch.where(skip[:, None, :], torch.inf, d)
        low = d.amin()
        self._min = low if self._min is None else torch.minimum(self._min,
                                                                low)
        self._near = self._near + (d <= self.NEAR).sum()
        self.draws += d.numel()
        self.pairs += d.numel() * (C - 1)
        if self.record:
            # within 2·NEAR: each draw's position, class and signed
            # distance to its nearest boundary (>= 0: the class above)
            idx = (d <= 2 * self.NEAR).flatten().nonzero()[:, 0]
            signed = torch.gather(sd, -1, nearest[..., None])[..., 0]
            self.records.append((self.calls, idx,
                                 draws.transpose(1, 2).flatten()[idx],
                                 signed.flatten()[idx]))
        self.calls += 1

    @property
    def value(self) -> float:
        """The smallest distance seen (``inf`` before any draw)."""
        return float("inf") if self._min is None else float(self._min)

    @property
    def near(self) -> int:
        return int(self._near)

    def chance_bound(self) -> float:
        """The most near draws that chance explains: a uniform draw lies
        within NEAR of a given boundary with probability at most 2·NEAR,
        so the count is at most Poisson of mean 2·NEAR·pairs; its mean
        plus six standard deviations, plus 6."""
        lam = 2 * self.NEAR * self.pairs
        return lam + 6 * lam ** 0.5 + 6

    def _table(self):
        """(positions, classes, signed distances) of the recorded draws,
        on the host, in draw order."""
        if not self.records:
            return (np.zeros(0, np.int64), np.zeros(0, np.int64),
                    np.zeros(0, np.float32))
        pos, cls, sd = zip(*[((call << 40) + idx.cpu().numpy(),
                              c.cpu().numpy(), s.cpu().numpy())
                             for call, idx, c, s in self.records])
        return np.concatenate(pos), np.concatenate(cls), np.concatenate(sd)

    def near_disagreements(self, other: "DrawMargin") -> NearDraws:
        """Compare two recorded runs of the same draws (the same calls of
        the same shapes) at every draw within NEAR of a boundary in
        either.  A draw may fall in another class in each only where the
        two runs' boundaries straddle it, no more than NEAR apart: its
        signed distances differ in sign, and by at most NEAR."""
        (pa, ca, sa), (pb, cb, sb) = self._table(), other._table()
        near = np.union1d(pa[np.abs(sa) <= self.NEAR],
                          pb[np.abs(sb) <= self.NEAR])
        ia = np.minimum(np.searchsorted(pa, near), max(len(pa) - 1, 0))
        ib = np.minimum(np.searchsorted(pb, near), max(len(pb) - 1, 0))
        both = ((pa[ia] == near) & (pb[ib] == near) if len(pa) and len(pb)
                else np.zeros(len(near), bool))
        ia, ib = ia[both], ib[both]
        shift = np.abs(sa[ia].astype(np.float64) - sb[ib])
        flip = ca[ia] != cb[ib]
        straddled = (sa[ia] >= 0) != (sb[ib] >= 0)
        bad = (shift > self.NEAR) | (flip & ~straddled)
        return NearDraws(checked=len(near), flipped=int(flip.sum()),
                         unexplained=int((~both).sum() + bad.sum()),
                         shift=float(shift.max()) if len(shift) else 0.0)


margin = DrawMargin()


@contextlib.contextmanager
def track_margin(record: bool = False):
    """Track the draws of the block in a new ``DrawMargin``, which it
    yields and which keeps its readings after the block; with ``record``
    each draw's class near a boundary is kept too."""
    global margin
    margin = DrawMargin(record)
    margin.on = True
    try:
        yield margin
    finally:
        margin.on = False
        margin = DrawMargin()


def sample_counts(key, probs: torch.Tensor, shots: int) -> torch.Tensor:
    """Multinomial shot counts of every row of ``(B, C)`` probabilities
    under one key, or of every ``(B, C)`` block of ``(..., B, C)`` under a
    key stack ``(..., 2)``, numpy or a device tensor of int32 words:
    bitwise the JAX package's ``sample_counts``
    (its draws for each key are ``uniform(key, (shots, B))``).

    Inverse-CDF sampling: each row's cumulative probabilities, a
    ``searchsorted(side="right")`` of each draw, capped at ``C-1``, and a
    per-class count of the draws.  Rows of zero mass (every entry clipped
    to 0) fall back to the uniform distribution; a row holding a NaN is
    drawn as uniform (so every other row keeps its draws) and comes back
    all NaN.  Counts accumulate in float32, exact to 2**24 in any order,
    and are returned in ``probs.dtype``.
    """
    *lead, B, C = probs.shape
    keys = key if torch.is_tensor(key) else np.asarray(key, np.uint32)
    if tuple(keys.shape[:-1]) != tuple(lead) or keys.shape[-1] != 2:
        raise ValueError(f"sample_counts: a key stack {keys.shape} for "
                         f"probabilities {tuple(probs.shape)}; it needs "
                         f"{(*lead, 2)}")
    p = probs.reshape(-1, B, C)
    nan_row = torch.isnan(p).any(-1, keepdim=True)                # (N, B, 1)
    flat = torch.ones_like(p) / C
    p = torch.where(nan_row, flat, torch.clamp(p, 0.0, 1.0))
    p = torch.where(p.sum(-1, keepdim=True) > 1e-12, p, flat)
    # the cumulative sum as sequential adds over the classes, then
    # renormalised: the JAX package's scan for C <= 3
    parts = [p[..., 0]]
    for j in range(1, C):
        parts.append(parts[-1] + p[..., j])
    cdf = torch.stack(parts, -1)
    cdf = cdf / cdf[..., -1:]                                     # (N, B, C)
    u = jr.uniform_stack(keys.reshape(-1, 2), (shots, B), p.dtype,
                         p.device)                                # (N, S, B)
    draws = torch.searchsorted(cdf, u.transpose(1, 2).contiguous(),
                               right=True)                        # (N, B, S)
    draws = torch.clamp(draws, max=C - 1)   # cumsum rounding below 1.0
    if margin.on:
        margin.update(u, cdf, nan_row[..., 0], draws)
    cls = torch.arange(C, device=p.device)
    counts = (draws[..., None] == cls).sum(-2, dtype=torch.float32)
    counts = torch.where(nan_row, torch.nan, counts)  # divergence surfaces
    return counts.to(probs.dtype).reshape(probs.shape)


# Calibrated instances.  Latencies reproduce Table-I orderings.
EXACT = Backend("exact")
FAKE = Backend("fake", depolarizing=0.015, readout_flip=0.03, shots=100,
               t_per_job=0.02, t_per_shot=1.2e-4)
AERSIM = Backend("aersim", depolarizing=0.03, readout_flip=0.015, shots=100,
                 t_per_job=0.04, t_per_shot=2.4e-4)
REAL = Backend("real", depolarizing=0.035, readout_flip=0.02, shots=100,
               t_per_job=0.05, t_per_shot=2.4e-4, t_queue=1.55)

BACKENDS = {b.name: b for b in (EXACT, FAKE, AERSIM, REAL)}


def get(name: str) -> Backend:
    return BACKENDS[name]
