"""CUDA kernel: XLA's float32 ``sin`` and ``cos`` on the CPU, elementwise.

It replaces no TPU kernel: the JAX package computes its gate matrices'
sines and cosines with ``jnp.sin`` / ``jnp.cos``, which XLA's CPU code
takes from glibc.  ``repro_torch.xla_trig.sincos`` launches it for a
CUDA tensor (the eager circuit's gates on the card); the plain version
it is held to is ``xla_trig.plain_sincos``.  The source, its design and
its bound are in ``csrc/xla_sincos.cu`` (the device function in
``csrc/xla_sincos.cuh``, which the tape kernel shares).

This wrapper takes CUDA tensors only and launches the kernel or raises:
it never falls back to the plain version.  ``xla_sincos.launches``
counts its launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.kernels import build

NAME = "xla_sincos"
SOURCE = "src/repro_torch/kernels/csrc/xla_sincos.cu"
REPLACES = ("none: XLA's float32 sin/cos on the CPU (jnp.sin / jnp.cos, "
            "src/repro/quantum/statevector.py:47)")

_P = ctypes.c_void_p


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = build.load(NAME)
    lib.xs_sincos.argtypes = [_P] * 3 + [ctypes.c_longlong, _P]
    lib.xs_sincos.restype = ctypes.c_int
    lib.xs_error_string.argtypes = [ctypes.c_int]
    lib.xs_error_string.restype = ctypes.c_char_p
    return lib


def xla_sincos(y: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(sin(y), cos(y))`` of a CUDA tensor ``y`` as XLA's float32
    functions on the CPU give them (``y`` taken as float32), each of
    ``y``'s shape, on ``y``'s device."""
    if not y.is_cuda:
        raise ValueError(f"xla_sincos takes a CUDA tensor, not one on "
                         f"{y.device}")
    x = y.float().contiguous()
    s, c = torch.empty_like(x), torch.empty_like(x)
    lib = _library()
    if x.device.index != torch.cuda.current_device():
        raise ValueError(f"{NAME}: the tensor lies on {x.device}, but the "
                         f"current device is {torch.cuda.current_device()}")
    err = lib.xs_sincos(x.data_ptr(), s.data_ptr(), c.data_ptr(), x.numel(),
                        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"{NAME} launch failed: "
                           f"{lib.xs_error_string(err).decode()}")
    xla_sincos.launches += 1
    return s, c


xla_sincos.launches = 0
