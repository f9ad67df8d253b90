"""CUDA kernel: fused distillation KL, per row ``KL(P_t ‖ softmax(z))``.

The port of the JAX package's Pallas kernel
``repro/kernels/distill_kl.py::distill_kl``.  The source, its design and
its bound are in ``csrc/distill_kl.cu``; the plain version it is held to
is ``ref.distill_kl``, with the same signature.  The JAX package has no
caller for it and no backward, and neither has the port.

This wrapper takes CUDA tensors only and launches the kernel or raises:
it never falls back to the plain version.  ``distill_kl.launches``
counts its launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

NAME = "distill_kl"
SOURCE = "src/repro_torch/kernels/csrc/distill_kl.cu"
REPLACES = "src/repro/kernels/distill_kl.py:28"

_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = build.load(NAME)
    lib.dk_distill_kl.argtypes = [_P] * 3 + [_I64] * 2 + [ctypes.c_float,
                                                          _P]
    lib.dk_distill_kl.restype = _I
    lib.dk_error_string.argtypes = [_I]
    lib.dk_error_string.restype = ctypes.c_char_p
    return lib


def distill_kl(teacher_probs: torch.Tensor, student_logits: torch.Tensor,
               eps: float = 1e-9) -> torch.Tensor:
    """Per-row KL of ``(B, C)`` float32 teacher probabilities (clipped to
    ``[eps, 1]``) against ``softmax`` of ``(B, C)`` float32 student
    logits → ``(B,)`` float32, on the card."""
    t, z = teacher_probs, student_logits
    if z.dim() != 2 or t.shape != z.shape or z.shape[1] < 1:
        raise ValueError(f"teacher {tuple(t.shape)} and logits "
                         f"{tuple(z.shape)} must be one (B, C) shape")
    for name, x in (("teacher_probs", t), ("student_logits", z)):
        if not x.is_cuda or x.device != z.device:
            raise ValueError(f"{name} must lie on {z.device} (CUDA)")
        if x.dtype != torch.float32:
            raise TypeError(f"distill_kl takes float32, {name} is "
                            f"{x.dtype}")
    if z.device.index != torch.cuda.current_device():
        raise ValueError(f"tensors lie on {z.device}, but the current "
                         f"device is {torch.cuda.current_device()}")
    t, z = t.contiguous(), z.contiguous()
    lib = _library()
    B, C = z.shape
    out = torch.empty((B,), dtype=torch.float32, device=z.device)
    stream = torch.cuda.current_stream(z.device).cuda_stream
    err = lib.dk_distill_kl(t.data_ptr(), z.data_ptr(), out.data_ptr(), B, C,
                            float(eps), stream)
    if err:
        raise RuntimeError(f"{NAME} launch failed: "
                           f"{lib.dk_error_string(err).decode()}")
    distill_kl.launches += 1
    return out


distill_kl.launches = 0
