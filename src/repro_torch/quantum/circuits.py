"""Parameterized quantum circuits used by the paper, on batched rows.

The port of ``repro/quantum/circuits.py``, built on
``repro_torch.quantum.statevector``.  Features ``x`` are ``(B, n)``, one
row an example; the trainable ``theta`` is shared by every row.

 - ``zz_feature_map``  : Qiskit ZZFeatureMap (H + P(2x_i) + pairwise
   ZZ-phase entanglement), the paper's VQC encoder (Fig. 15).
 - ``real_amplitudes`` : Qiskit RealAmplitudes ansatz (ry layers + CX
   entanglement), the paper's VQC ansatz.
 - ``qcnn``            : quantum convolutional NN (alternating 2-qubit conv
   unitaries + pooling that halves the active register), App. D / Fig. 14.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from repro_torch import xla_trig
from repro_torch.quantum import statevector as sv


# ---------------------------------------------------------------------------
# feature maps
# ---------------------------------------------------------------------------
def _p_phase(psi, theta, q):
    """Phase gate P(θ) = diag(1, e^{iθ}), one matrix a row when θ is a
    per-row angle."""
    th = torch.as_tensor(theta, device=psi.device).float()
    e = xla_trig.expi(th)
    one, z = torch.ones_like(e), torch.zeros_like(e)
    return sv._apply_1q(psi, sv._mat(one, z, z, e), q)


def zz_feature_map(x: torch.Tensor, *, reps: int = 2) -> torch.Tensor:
    """ZZFeatureMap(n_qubits=n, reps) of every row of x ``(B, n)``."""
    B, n = x.shape
    psi = sv.zero_state(n, B, x.device)
    for _ in range(reps):
        for q in range(n):
            psi = sv.h(psi, q)
            psi = _p_phase(psi, 2.0 * x[:, q], q)
        for i in range(n):
            for j in range(i + 1, n):
                phi = 2.0 * (math.pi - x[:, i]) * (math.pi - x[:, j])
                psi = sv.cx(psi, i, j)
                psi = _p_phase(psi, phi, j)
                psi = sv.cx(psi, i, j)
    return psi


# ---------------------------------------------------------------------------
# ansatz
# ---------------------------------------------------------------------------
def real_amplitudes_n_params(n_qubits: int, reps: int = 3) -> int:
    return n_qubits * (reps + 1)


def real_amplitudes(psi: torch.Tensor, theta: torch.Tensor, *,
                    reps: int = 3, entangle: str = "full") -> torch.Tensor:
    """RealAmplitudes ansatz applied to ``psi``.  theta: (n*(reps+1),)."""
    n = psi.dim() - 1
    theta = theta.reshape(reps + 1, n)
    for r in range(reps):
        for q in range(n):
            psi = sv.ry(psi, theta[r, q], q)
        if entangle == "full":
            pairs = [(i, j) for i in range(n) for j in range(i + 1, n)]
        else:  # linear
            pairs = [(i, i + 1) for i in range(n - 1)]
        for (i, j) in pairs:
            psi = sv.cx(psi, i, j)
    for q in range(n):
        psi = sv.ry(psi, theta[reps, q], q)
    return psi


# ---------------------------------------------------------------------------
# QCNN (App. D): conv + pool 2-qubit primitives, log2(n) stages
# ---------------------------------------------------------------------------
def _conv2(psi, p, q1, q2):
    """Qiskit-tutorial conv circuit: 3 params per 2-qubit block."""
    psi = sv.rz(psi, -math.pi / 2, q2)
    psi = sv.cx(psi, q2, q1)
    psi = sv.rz(psi, p[0], q1)
    psi = sv.ry(psi, p[1], q2)
    psi = sv.cx(psi, q1, q2)
    psi = sv.ry(psi, p[2], q2)
    psi = sv.cx(psi, q2, q1)
    psi = sv.rz(psi, math.pi / 2, q1)
    return psi


def _pool2(psi, p, src, dst):
    """Pooling: entangle src→dst then discard src from the active set."""
    psi = sv.rz(psi, -math.pi / 2, dst)
    psi = sv.cx(psi, dst, src)
    psi = sv.rz(psi, p[0], src)
    psi = sv.ry(psi, p[1], dst)
    psi = sv.cx(psi, src, dst)
    psi = sv.ry(psi, p[2], dst)
    return psi


def qcnn_n_params(n_qubits: int) -> int:
    """3 params per conv pair + 3 per pool pair per stage."""
    n, total = n_qubits, 0
    while n > 1:
        pairs = n // 2
        total += 3 * pairs          # conv
        total += 3 * pairs          # pool
        n -= pairs
    return total


def qcnn(psi: torch.Tensor, theta: torch.Tensor
         ) -> Tuple[torch.Tensor, int]:
    """Apply QCNN stages; returns (psi, final_qubit_index).

    Active register starts as all qubits; each stage convolves adjacent
    pairs then pools the first of each pair into the second, halving the
    register until one qubit remains (classification readout qubit).
    """
    n = psi.dim() - 1
    active = list(range(n))
    k = 0
    while len(active) > 1:
        pairs = [(active[2 * i], active[2 * i + 1])
                 for i in range(len(active) // 2)]
        for (a, b) in pairs:
            psi = _conv2(psi, theta[k:k + 3], a, b)
            k += 3
        survivors = []
        for (a, b) in pairs:
            psi = _pool2(psi, theta[k:k + 3], a, b)
            k += 3
            survivors.append(b)
        if len(active) % 2:
            survivors.append(active[-1])
        active = survivors
    return psi, active[0]
