"""SamplerQNN heads: parity interpret, loss and accuracy on class probs.

The port of ``repro/quantum/qnn.py``.  The circuit's basis probabilities
are mapped to classes by the **parity of the bitstring** (paper Sec.
I-B.2).  Two model families (Table II):

  - VQC  : ZZFeatureMap(reps=2) + RealAmplitudes(reps=3)      [Experiment I]
  - QCNN : ZZFeatureMap encoding + conv/pool stages            [Experiment II]

Two forwards compute the same class probabilities: ``make_forward``,
the eager circuit on the statevector simulator (``quantum/circuits.py``,
the sequential engine's forward, as in the JAX package), and
``quantum/tape.py``'s compiled tape (the batched engine's).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch import random as jr
from repro_torch.quantum import circuits as C
from repro_torch.quantum import statevector as sv
from repro_torch.quantum.circuits import (  # noqa: F401  (re-export)
    qcnn_n_params, real_amplitudes_n_params)


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


def last_qubit_interpret(psi: torch.Tensor, q: int) -> torch.Tensor:
    """P(qubit q = 0/1) per row, ``(B, 2)``: the QCNN readout on the
    surviving qubit."""
    p = torch.abs(psi) ** 2
    axes = tuple(i for i in range(1, psi.dim()) if i != q + 1)
    return p.sum(dim=axes) if axes else p


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


def _forward_one(spec: QNNSpec, theta: torch.Tensor,
                 X: torch.Tensor) -> torch.Tensor:
    """Class probabilities ``(B, n_classes)`` of the rows of X ``(B, n)``:
    the JAX package's per-example forward, vectorised over rows (it
    ``vmap``s this function)."""
    psi = C.zz_feature_map(X, reps=spec.fm_reps)
    if spec.kind == "vqc":
        psi = C.real_amplitudes(psi, theta, reps=spec.ansatz_reps)
        return parity_interpret(sv.probabilities(psi), spec.n_qubits,
                                spec.n_classes)
    if spec.kind == "qcnn":
        psi, q = C.qcnn(psi, theta)
        if spec.n_classes == 2:
            return last_qubit_interpret(psi, q)
        # >2 classes: fall back to parity on the full register
        return parity_interpret(sv.probabilities(psi), spec.n_qubits,
                                spec.n_classes)
    raise ValueError(spec.kind)


def make_forward(spec: QNNSpec, device) -> Callable:
    """(theta, X (B, n)) → class probs (B, n_classes) on ``device``, by
    the eager circuit."""
    device = torch.device(device)

    def forward(theta, X):
        theta = torch.as_tensor(theta).to(device=device,
                                          dtype=torch.float32)
        X = torch.as_tensor(X).to(device=device, dtype=torch.float32)
        return _forward_one(spec, theta, X)

    return forward


def nll_loss(probs: torch.Tensor, labels: torch.Tensor,
             eps: float = 1e-9) -> torch.Tensor:
    """Mean negative log-likelihood of class probabilities."""
    p = torch.gather(probs, 1, labels.long()[:, None])[:, 0]
    return -torch.mean(torch.log(p + eps))


def accuracy(probs: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return torch.mean((torch.argmax(probs, dim=1) == labels).float())


def make_loss_fn(spec: QNNSpec, X: torch.Tensor, y: torch.Tensor,
                 backend=None) -> Callable:
    """theta → scalar NLL on (X, y), optionally through a noisy backend,
    on the device of ``X``.

    With a finite-shot backend (``backend.shots > 0``) the loss is
    **keyed**, called as ``loss(theta, key)`` with a per-evaluation
    ``backends.eval_key``, so shot sampling is live and deterministic by
    seed; otherwise the channel-only one-argument form is returned."""
    fwd = make_forward(spec, X.device)

    if backend is not None and backend.shots:
        def loss_sampled(theta, key):
            probs = backend.transform_probs(fwd(theta, X), key)
            return nll_loss(probs, y)

        return loss_sampled

    def loss(theta):
        probs = fwd(theta, X)
        if backend is not None:
            probs = backend.apply_channel(probs)
        return nll_loss(probs, y)

    return loss
