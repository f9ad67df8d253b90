"""Kernel dispatch by the tensor's device.

A CUDA tensor always goes to the hand-written kernel, which launches or
raises; a CPU tensor goes to the plain version in ``ref``.  There is no
fallback from one to the other.
"""
from __future__ import annotations

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import lora_matmul as _lm
from repro_torch.kernels import ref
from repro_torch.kernels import statevector_gates as _svg


def _on_cpu(t, name: str) -> bool:
    if t.is_cuda:
        return False
    if t.device.type != "cpu":
        raise ValueError(f"no {name} for device {t.device}")
    return True


def statevector_gate(psi_re, psi_im, g_re, g_im, target: int, control: int,
                     n_qubits: int):
    if not _on_cpu(psi_re, "statevector_gate"):
        return _svg.statevector_gate(psi_re, psi_im, g_re, g_im, target,
                                     control, n_qubits)
    return ref.statevector_gate(psi_re, psi_im, g_re, g_im, target,
                                control, n_qubits)


def lora_matmul(x, w, a, b, scale: float):
    if not _on_cpu(x, "lora_matmul"):
        return _lm.lora_matmul(x, w, a, b, scale)
    return ref.lora_matmul(x, w, a, b, scale)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    scale: float = None):
    if not _on_cpu(q, "flash_attention"):
        return _fa.flash_attention(q, k, v, causal=causal, window=window,
                                   scale=scale)
    return ref.flash_attention(q, k, v, causal=causal, window=window,
                               scale=scale)
