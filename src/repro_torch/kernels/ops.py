"""Kernel dispatch by the tensor's device.

A CUDA tensor always goes to the hand-written kernel, which launches or
raises; a CPU tensor goes to the plain version in ``ref``.  There is no
fallback from one to the other.
"""
from __future__ import annotations

from repro_torch.kernels import ref
from repro_torch.kernels import statevector_gates as _svg


def statevector_gate(psi_re, psi_im, g_re, g_im, target: int, control: int,
                     n_qubits: int):
    if psi_re.is_cuda:
        return _svg.statevector_gate(psi_re, psi_im, g_re, g_im, target,
                                     control, n_qubits)
    if psi_re.device.type != "cpu":
        raise ValueError(f"no statevector_gate for device {psi_re.device}")
    return ref.statevector_gate(psi_re, psi_im, g_re, g_im, target,
                                control, n_qubits)
