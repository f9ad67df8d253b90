"""Quantum execution backends: ideal / noisy simulators / emulated QPU.

The port of ``repro/quantum/backends.py``:
 - exact:    statevector probabilities (AerSimulator, noise-free)
 - aersim:   depolarizing + readout bit-flip noise (AerSimulator with
             the IBM_Brisbane noise model)
 - fake:     FakeManila-style snapshot (stronger readout error)
 - real:     aersim's noise plus queue/latency emulation for the
             communication-time accounting of Table I

Each backend transforms *class probabilities* by a deterministic noise
channel (``apply_channel``) and reports a wall-time estimate per
evaluation batch (``eval_time``).  Finite-shot sampling (``shots > 0``)
is not ported yet: ``transform_probs`` raises for it rather than run
the channel alone (ROADMAP §1, "finite-shot sampling").

The reserved slot and client ids below are those of the JAX package's
key contract ``eval_key(PRNGKey(seed), round, client, slot)``.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

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

SHOTS_NOT_PORTED = ("finite-shot sampling (shots > 0) is not ported yet "
                    "(ROADMAP §1, 'finite-shot sampling'); use the exact "
                    "backend or shots_override=0")


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
        if self.depolarizing:
            probs = (1 - self.depolarizing) * probs + self.depolarizing / C
        if self.readout_flip:
            # symmetric confusion: stay w.p. 1-f, uniform flip otherwise
            f = self.readout_flip
            eye = torch.eye(C, device=probs.device)
            conf = (1 - f) * eye + f / (C - 1) * (1 - eye)
            probs = probs @ conf.to(probs.dtype)
        return probs

    def transform_probs(self, probs: torch.Tensor) -> torch.Tensor:
        """Channel + finite-shot sampling; the sampling is not ported."""
        if self.shots:
            raise NotImplementedError(SHOTS_NOT_PORTED)
        return self.apply_channel(probs)

    def eval_time(self, n_circuits: int) -> float:
        """Estimated wall-time for one optimizer evaluation over a batch."""
        return (self.t_queue + self.t_per_job
                + self.t_per_shot * max(self.shots, 1) * n_circuits)


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
