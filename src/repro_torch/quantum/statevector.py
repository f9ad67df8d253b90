"""Eager complex64 statevector simulator, batched over rows.

The port of ``repro/quantum/statevector.py``.  A batch of B statevectors
of n qubits is a ``(B, 2, …, 2)`` complex64 tensor: the leading axis is
the row (the JAX package ``vmap``s its per-example circuit over rows,
``repro/quantum/qnn.py:89``), and qubit ``q`` is axis ``q + 1``
(big-endian bitstrings, the parity-interpret convention of ``qnn.py``).

Gates act by ``tensordot`` + ``movedim``.  A gate matrix is shared by
every row (``(2, 2)``, ``(4, 4)``); a one-qubit gate whose angle is a
per-row feature has one matrix a row (``(B, 2, 2)``) and contracts
through ``einsum``.  Two-qubit gates take shared angles only, as every
circuit of the paper uses them.  This module is the plain
reference the compiled tape (``quantum/tape.py``) is held to, and the
forward of the sequential engine.  Rotation angles' sines and cosines
are XLA's float32 ones (``xla_trig``), as the JAX package computes them
on the CPU.
"""
from __future__ import annotations

import math

import torch

from repro_torch import xla_trig

CDTYPE = torch.complex64


def zero_state(n_qubits: int, batch: int = 1, device="cpu") -> torch.Tensor:
    """|0…0⟩ for ``batch`` rows: ``(batch, 2, …, 2)``."""
    psi = torch.zeros((batch,) + (2,) * n_qubits, dtype=CDTYPE,
                      device=device)
    psi[(slice(None),) + (0,) * n_qubits] = 1.0
    return psi


def _apply_1q(psi: torch.Tensor, gate: torch.Tensor, q: int) -> torch.Tensor:
    ax = q + 1
    if gate.dim() == 2:
        psi = torch.tensordot(gate, psi, dims=([1], [ax]))
        return torch.movedim(psi, 0, ax)
    psi = torch.movedim(psi, ax, -1)
    psi = torch.einsum("bij,b...j->b...i", gate, psi)
    return torch.movedim(psi, -1, ax)


def _apply_2q(psi: torch.Tensor, gate: torch.Tensor, q1: int, q2: int
              ) -> torch.Tensor:
    a1, a2 = q1 + 1, q2 + 1
    g = gate.reshape(2, 2, 2, 2)
    psi = torch.tensordot(g, psi, dims=([2, 3], [a1, a2]))
    return torch.movedim(psi, (0, 1), (a1, a2))


# --- gate matrices ---------------------------------------------------------
# theta of any shape (…) gives matrices (…, 2, 2): () for a shared angle,
# (B,) for one angle a row
def _mat(a, b, c, d) -> torch.Tensor:
    return torch.stack([torch.stack([a, b], -1), torch.stack([c, d], -1)],
                       -2)


_H = torch.tensor([[1, 1], [1, -1]], dtype=CDTYPE) / torch.tensor(
    math.sqrt(2.0), dtype=torch.float32).to(CDTYPE)
_X = torch.tensor([[0, 1], [1, 0]], dtype=CDTYPE)
_Z = torch.tensor([[1, 0], [0, -1]], dtype=CDTYPE)
_I2 = torch.eye(2, dtype=CDTYPE)
_CX = torch.tensor([[1, 0, 0, 0], [0, 1, 0, 0],
                    [0, 0, 0, 1], [0, 0, 1, 0]], dtype=CDTYPE)
_CZ = torch.diag(torch.tensor([1, 1, 1, -1], dtype=CDTYPE))


_ON_DEVICE = {}                  # (id of a constant, device) → its copy


def _const(m: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A constant gate matrix on the device of ``like``, copied there
    once."""
    key = (id(m), str(like.device))
    if key not in _ON_DEVICE:
        _ON_DEVICE[key] = m.to(like.device)
    return _ON_DEVICE[key]


def rx_mat(theta: torch.Tensor) -> torch.Tensor:
    sh, ch = xla_trig.sincos(theta / 2)
    c = ch.to(CDTYPE)
    s = torch.complex(torch.zeros_like(sh), -sh)
    return _mat(c, s, s, c)


def ry_mat(theta: torch.Tensor) -> torch.Tensor:
    sh, ch = xla_trig.sincos(theta / 2)
    c, s = ch.to(CDTYPE), sh.to(CDTYPE)
    return _mat(c, -s, s, c)


def rz_mat(theta: torch.Tensor) -> torch.Tensor:
    # exp(-0.5j·θ) as XLA takes it: cos and sin of -θ/2
    e = xla_trig.expi(theta * -0.5)
    z = torch.zeros_like(e)
    return _mat(e, z, z, torch.conj(e))


def _angle(theta, psi: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(theta, dtype=torch.float32, device=psi.device)


# --- public ops ------------------------------------------------------------
def h(psi, q):
    return _apply_1q(psi, _const(_H, psi), q)


def x(psi, q):
    return _apply_1q(psi, _const(_X, psi), q)


def rx(psi, theta, q):
    return _apply_1q(psi, rx_mat(_angle(theta, psi)), q)


def ry(psi, theta, q):
    return _apply_1q(psi, ry_mat(_angle(theta, psi)), q)


def rz(psi, theta, q):
    return _apply_1q(psi, rz_mat(_angle(theta, psi)), q)


def cx(psi, control, target):
    return _apply_2q(psi, _const(_CX, psi), control, target)


def cz(psi, q1, q2):
    return _apply_2q(psi, _const(_CZ, psi), q1, q2)


def crz(psi, theta, control, target):
    th = _angle(theta, psi)
    g = torch.diag(torch.cat([torch.ones(2, dtype=CDTYPE, device=th.device),
                              torch.stack([xla_trig.expi(th * -0.5),
                                           xla_trig.expi(th * 0.5)])]))
    return _apply_2q(psi, g, control, target)


def probabilities(psi: torch.Tensor) -> torch.Tensor:
    """|amp|² over the 2**n computational basis (big-endian flatten):
    ``(B, 2**n)``."""
    return torch.abs(psi.reshape(psi.shape[0], -1)) ** 2


def expect_z(psi: torch.Tensor, q: int) -> torch.Tensor:
    """⟨Z_q⟩ per row, ``(B,)``."""
    p = torch.abs(psi) ** 2
    axes = tuple(i for i in range(1, psi.dim()) if i != q + 1)
    pq = p.sum(dim=axes) if axes else p
    return pq[:, 0] - pq[:, 1]


def norm(psi: torch.Tensor) -> torch.Tensor:
    """‖ψ‖ per row, ``(B,)``."""
    return torch.sqrt((torch.abs(psi) ** 2).reshape(psi.shape[0], -1)
                      .sum(-1))
