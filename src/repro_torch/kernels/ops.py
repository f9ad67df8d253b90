"""Kernel dispatch by the tensor's device.

A CUDA tensor always goes to the hand-written kernel, which launches or
raises; a CPU tensor goes to the plain version in ``ref``.  There is no
fallback from one to the other.  A fake tensor (``FakeTensorMode``,
``counts.is_abstract``), on whatever device, takes the card's path: the
wrappers of ``lora_matmul``, ``flash_attention`` and ``int4_matmul``
allocate what a launch would and count it (``counts.tally``), launching
nothing.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import counts
from repro_torch.kernels import distill_kl as _kl
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import int4_matmul as _i4
from repro_torch.kernels import lora_matmul as _lm
from repro_torch.kernels import ref
from repro_torch.kernels import statevector_gates as _svg
from repro_torch.kernels import statevector_tape as _svt


def _on_cpu(t, name: str) -> bool:
    if t.is_cuda or counts.is_abstract(t):
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


def statevector_tape(angles, gate_id, target, control, n_qubits: int):
    if not _on_cpu(angles, "statevector_tape"):
        return _svt.statevector_tape(angles, gate_id, target, control,
                                     n_qubits)
    return ref.statevector_tape(angles, gate_id, target, control, n_qubits)


def lora_matmul(x, w, a, b, scale: float):
    if not _on_cpu(x, "lora_matmul"):
        return _lm.lora_matmul(x, w, a, b, scale)
    return ref.lora_matmul(x, w, a, b, scale)


def int4_matmul(x, packed, scales, qblock: int = 64,
                round_to=torch.float32):
    if not _on_cpu(x, "int4_matmul"):
        return _i4.int4_matmul(x, packed, scales, qblock, round_to)
    return ref.int4_matmul(x, packed, scales, qblock, round_to)


def distill_kl(teacher_probs, student_logits, eps: float = 1e-9):
    if not _on_cpu(student_logits, "distill_kl"):
        return _kl.distill_kl(teacher_probs, student_logits, eps)
    return ref.distill_kl(teacher_probs, student_logits, eps)


def distill_kl_mean(teacher_probs, student_logits, eps: float = 1e-9):
    return torch.mean(distill_kl(teacher_probs, student_logits, eps))


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    scale: float = None):
    if not _on_cpu(q, "flash_attention"):
        return _fa.flash_attention(q, k, v, causal=causal, window=window,
                                   scale=scale)
    return ref.flash_attention(q, k, v, causal=causal, window=window,
                               scale=scale)


def on_card_path(t) -> bool:
    """Does ``t`` take the card's path: a CUDA or an abstract tensor?"""
    return t.is_cuda or counts.is_abstract(t)
