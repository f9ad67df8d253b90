"""SamplerQNN heads: parity interpret, loss and accuracy on class probs.

The port of ``repro/quantum/qnn.py``.  The circuit's basis probabilities
are mapped to classes by the **parity of the bitstring** (paper Sec.
I-B.2).  Two model families (Table II):

  - VQC  : ZZFeatureMap(reps=2) + RealAmplitudes(reps=3)      [Experiment I]
  - QCNN : ZZFeatureMap encoding + conv/pool stages            [Experiment II]

The forward itself is the compiled tape (``quantum/tape.py``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch import random as jr


def real_amplitudes_n_params(n_qubits: int, reps: int = 3) -> int:
    return n_qubits * (reps + 1)


def qcnn_n_params(n_qubits: int) -> int:
    """3 params per conv pair + 3 per pool pair per stage."""
    n, total = n_qubits, 0
    while n > 1:
        pairs = n // 2
        total += 3 * pairs          # conv
        total += 3 * pairs          # pool
        n -= pairs
    return total


def parity_interpret(probs: torch.Tensor, n_qubits: int,
                     n_classes: int = 2) -> torch.Tensor:
    """Map 2**n basis probabilities to class probs by bitstring parity
    (popcount mod n_classes)."""
    idx = torch.arange(probs.shape[-1], device=probs.device)
    pop = torch.zeros_like(idx)
    for b in range(n_qubits):
        pop = pop + ((idx >> b) & 1)
    onehot = torch.nn.functional.one_hot(pop % n_classes,
                                         n_classes).to(probs.dtype)
    return probs @ onehot


@dataclass(frozen=True)
class QNNSpec:
    kind: str                  # "vqc" | "qcnn"
    n_qubits: int = 4
    n_classes: int = 2
    fm_reps: int = 2
    ansatz_reps: int = 3

    @property
    def n_params(self) -> int:
        if self.kind == "vqc":
            return real_amplitudes_n_params(self.n_qubits, self.ansatz_reps)
        if self.kind == "qcnn":
            return qcnn_n_params(self.n_qubits)
        raise ValueError(self.kind)

    def init_params(self, key) -> torch.Tensor:
        """float32 uniform draws in [-π, π) from a ``repro_torch.random``
        key, as ``jax.random.uniform`` makes them."""
        return torch.from_numpy(
            jr.uniform(key, (self.n_params,), -math.pi, math.pi))


def nll_loss(probs: torch.Tensor, labels: torch.Tensor,
             eps: float = 1e-9) -> torch.Tensor:
    """Mean negative log-likelihood of class probabilities."""
    p = torch.gather(probs, 1, labels.long()[:, None])[:, 0]
    return -torch.mean(torch.log(p + eps))


def accuracy(probs: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return torch.mean((torch.argmax(probs, dim=1) == labels).float())
