"""CUDA kernel: batched (controlled) 2×2 gate apply on flat statevectors.

The port of the JAX package's Pallas kernel
``repro/kernels/statevector_gates.py::statevector_gate``.  The source,
its design and its bound are in ``csrc/statevector_gate.cu``; the plain
version it is held to is ``ref.statevector_gate``, with the same
signature.  This wrapper takes CUDA tensors only and launches the kernel
or raises: it never falls back to the plain version.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

NAME = "statevector_gate"
SOURCE = "src/repro_torch/kernels/csrc/statevector_gate.cu"
REPLACES = "src/repro/kernels/statevector_gates.py:61"

_P = ctypes.c_void_p


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """Build (first call only) and load the kernel; declare its C
    signature once."""
    lib = build.load(NAME)
    fn = lib.svg_statevector_gate
    fn.argtypes = [_P] * 6 + [ctypes.c_longlong, ctypes.c_int,
                              ctypes.c_int, ctypes.c_int, _P]
    fn.restype = ctypes.c_int
    lib.svg_error_string.argtypes = [ctypes.c_int]
    lib.svg_error_string.restype = ctypes.c_char_p
    return lib


def _check(psi_re, psi_im, g_re, g_im, target, control, n_qubits):
    B = psi_re.shape[0] if psi_re.dim() == 2 else -1
    for name, t, shape in (("psi_re", psi_re, (B, 1 << n_qubits)),
                           ("psi_im", psi_im, (B, 1 << n_qubits)),
                           ("g_re", g_re, (B, 2, 2)),
                           ("g_im", g_im, (B, 2, 2))):
        if not t.is_cuda or t.device != psi_re.device:
            raise ValueError(f"{name} must lie on {psi_re.device} (CUDA)")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if g_re.data_ptr() % 16 or g_im.data_ptr() % 16:
        raise ValueError("gate planes must be 16-byte aligned (float4)")
    if not (1 <= n_qubits <= 30 and 0 <= target < n_qubits
            and -1 <= control < n_qubits and control != target):
        raise ValueError(f"bad gate: target={target} control={control} "
                         f"n_qubits={n_qubits}")


def statevector_gate(psi_re: torch.Tensor, psi_im: torch.Tensor,
                     g_re: torch.Tensor, g_im: torch.Tensor,
                     target: int, control: int, n_qubits: int):
    """New ``(re, im)`` planes ``(B, 2**n)`` after one gate per row."""
    target, control, n_qubits = int(target), int(control), int(n_qubits)
    _check(psi_re, psi_im, g_re, g_im, target, control, n_qubits)
    lib = _library()
    if psi_re.device.index != torch.cuda.current_device():
        raise ValueError(f"tensors lie on {psi_re.device}, but the "
                         f"current device is {torch.cuda.current_device()}")
    out_re, out_im = torch.empty_like(psi_re), torch.empty_like(psi_im)
    stream = torch.cuda.current_stream(psi_re.device).cuda_stream
    err = lib.svg_statevector_gate(
        psi_re.data_ptr(), psi_im.data_ptr(), g_re.data_ptr(),
        g_im.data_ptr(), out_re.data_ptr(), out_im.data_ptr(),
        psi_re.shape[0], n_qubits, target, control, stream)
    if err:
        raise RuntimeError(f"{NAME} launch failed: "
                           f"{lib.svg_error_string(err).decode()}")
    statevector_gate.launches += 1
    return out_re, out_im


statevector_gate.launches = 0
