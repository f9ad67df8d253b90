"""CUDA kernel: a weight draw, ``jax.random.truncated_normal`` times a
scale, in the weight's dtype.

It replaces no TPU kernel: the JAX package draws its base weights with
``jax.random.truncated_normal`` (``repro/models/common.py``), and the
port's ``models.common.init_dense`` launches this kernel for a leaf on
the card, one launch a leaf.  The plain version it is held to, bit for
bit, is ``plain``: ``random.truncated_normal`` times the scale, rounded
to the dtype.  The source, its design and its bound are in
``csrc/trunc_normal.cu`` (the per-value device function in
``csrc/trunc_normal.cuh``).

``trunc_normal`` draws on a CUDA device only and launches the kernel or
raises: it never falls back to the plain version.
``trunc_normal.launches`` counts its launches.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Tuple

import numpy as np
import torch

from repro_torch import random as jr
from repro_torch.kernels import build

NAME = "trunc_normal"
SOURCE = "src/repro_torch/kernels/csrc/trunc_normal.cu"
REPLACES = ("none: jax.random.truncated_normal, the JAX package's weight "
            "draw (src/repro/models/common.py:23)")

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_F = ctypes.c_float


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = build.load(NAME)
    lib.tn_draw.argtypes = [_P, ctypes.c_longlong, ctypes.c_ulonglong,
                            ctypes.c_uint, ctypes.c_uint] + [_F] * 5 + [
                                ctypes.c_int, _P]
    lib.tn_draw.restype = ctypes.c_int
    lib.tn_error_string.argtypes = [ctypes.c_int]
    lib.tn_error_string.restype = ctypes.c_char_p
    return lib


def bounds(lower: float, upper: float) -> Tuple[float, float, float, float]:
    """(a, span, clamp_lo, clamp_hi) of a draw truncated to ``(lower,
    upper)``, float32 values as ``random.truncated_normal`` makes them:
    its uniforms lie in ``[a, a + span)``, its values in ``[clamp_lo,
    clamp_hi]``."""
    lower, upper = np.float32(lower), np.float32(upper)
    sqrt2 = np.float32(np.sqrt(2))
    a = np.float32(math.erf(float(lower / sqrt2)))
    b = np.float32(math.erf(float(upper / sqrt2)))
    return (float(a), float(b - a),
            float(np.nextafter(lower, np.float32(np.inf))),
            float(np.nextafter(upper, np.float32(-np.inf))))


def plain(key: np.ndarray, n: int, std: float, dtype, device,
          start: int = 0) -> torch.Tensor:
    """The plain version: elements ``start .. start + n - 1`` of
    ``truncated_normal(key, -2, 2)``, times ``std``, in ``dtype``, drawn
    in torch on ``device``."""
    return (jr.truncated_normal(key, -2.0, 2.0, (n,), device, start=start)
            * std).to(dtype)


def trunc_normal(key: np.ndarray, n: int, std: float, dtype, device,
                 start: int = 0) -> torch.Tensor:
    """Elements ``start .. start + n - 1`` of ``truncated_normal(key, -2,
    2)`` times ``std`` in ``dtype`` (float32 or bfloat16: the configs'
    dtypes), a
    flat tensor on the CUDA ``device``, in one launch; bitwise
    ``plain``."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"{NAME} draws on a CUDA device, not {device}")
    if dtype not in _DTYPES:
        raise ValueError(f"{NAME} draws float32 or bfloat16, not {dtype}")
    k0, k1 = (int(v) for v in np.asarray(key, np.uint32)[:2])
    a, span, lo, hi = bounds(-2.0, 2.0)
    lib = _library()
    with torch.cuda.device(device):     # the draw's card, its stream
        out = torch.empty(n, dtype=dtype, device=device)
        err = lib.tn_draw(out.data_ptr(), n, start, k0, k1, a, span, lo,
                          hi, float(np.float32(std)), _DTYPES[dtype],
                          torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"{NAME} launch failed: "
                           f"{lib.tn_error_string(err).decode()}")
    trunc_normal.launches += 1
    return out


trunc_normal.launches = 0
