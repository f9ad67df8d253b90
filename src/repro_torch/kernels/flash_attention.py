"""CUDA kernels: grouped-head flash attention, forward and backward.

The port of the JAX package's Pallas kernel
``repro/kernels/flash_attention.py::flash_attention``.  The source, its
design and its bound are in ``csrc/flash_attention.cu``; the plain
version it is held to is ``ref.flash_attention``, with the same
signature: q ``(B, S, H, D)`` and k/v ``(B, Sk, KH, D)`` in the model's
layout, q-head ``h`` reading kv-head ``h // (H // KH)``.

The JAX package trains through the jnp chunked flash of
``models/attention.py``, so it has no backward kernel; here the gradient
is a ``torch.autograd.Function`` whose backward is the FA2-style pair of
passes in the same source (dK/dV per k-tile, then dQ per q-tile), from
the logsumexp the forward saves.

Each wrapper takes CUDA tensors only and launches its kernels or raises:
it never falls back to the plain version.  ``flash_attention.launches``
counts forward launches; ``flash_attention_bwd.launches`` counts backward
calls, each one launch of the two backward passes.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

NAME = "flash_attention"
SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"
REPLACES = "src/repro/kernels/flash_attention.py:68"
HEAD_DIMS = (32, 64, 128)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = build.load(NAME)
    dims = [_I] * 6 + [ctypes.c_float, _I, _I]
    lib.fa_forward.argtypes = [_P] * 5 + dims + [_I64] * 9 + [_I, _P]
    lib.fa_forward.restype = _I
    lib.fa_backward.argtypes = [_P] * 9 + dims + [_I64] * 12 + [_I, _P]
    lib.fa_backward.restype = _I
    lib.fa_error_string.argtypes = [_I]
    lib.fa_error_string.restype = ctypes.c_char_p
    return lib


def _check(q, k, v, *more):
    B, S, H, D = q.shape
    if k.dim() != 4 or k.shape[0] != B or k.shape[3] != D \
            or v.shape != k.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} disagree")
    KH = k.shape[2]
    if H % KH:
        raise ValueError(f"{H} q-heads do not group over {KH} kv-heads")
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not in {HEAD_DIMS}")
    if q.dtype not in DTYPES:
        raise TypeError(f"flash_attention takes float32 or bfloat16, "
                        f"not {q.dtype}")
    for t in (q, k, v) + more:
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"operands must lie on {q.device} (CUDA)")
        if t.dtype != q.dtype:
            raise TypeError(f"operands mix {t.dtype} and {q.dtype}")
        if t.stride(-1) != 1:
            raise ValueError("the head dim must have unit stride")
    if q.device.index != torch.cuda.current_device():
        raise ValueError(f"tensors lie on {q.device}, but the current "
                         f"device is {torch.cuda.current_device()}")


def _raise(lib, err, what):
    if err:
        raise RuntimeError(f"{what} launch failed: "
                           f"{lib.fa_error_string(err).decode()}")


def _forward(q, k, v, causal: bool, window: int, scale: float):
    _check(q, k, v)
    B, S, H, D = q.shape
    Sk, KH = k.shape[1], k.shape[2]
    lib = _library()
    out = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    err = lib.fa_forward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), B, S, Sk, H, KH, D, float(scale), int(causal),
        int(window), *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    _raise(lib, err, NAME)
    flash_attention.launches += 1
    return out, lse


def flash_attention_bwd(q, k, v, out, lse, dout, *, causal: bool = True,
                        window: int = 0, scale: float = None):
    """``(dq, dk, dv)`` of ``flash_attention`` at ``(q, k, v)``, given its
    output ``out`` (contiguous) and row logsumexp ``lse`` ``(B, H, S)``."""
    if dout.stride(-1) != 1:
        dout = dout.contiguous()
    _check(q, k, v, out, dout)
    B, S, H, D = q.shape
    Sk, KH = k.shape[1], k.shape[2]
    if not out.is_contiguous() or tuple(out.shape) != (B, S, H, D):
        raise ValueError("out must be the forward's contiguous output")
    if tuple(dout.shape) != (B, S, H, D):
        raise ValueError(f"dout has shape {tuple(dout.shape)}")
    if lse.dtype != torch.float32 or tuple(lse.shape) != (B, H, S) \
            or not lse.is_contiguous():
        raise ValueError("lse must be the forward's (B, H, S) float32")
    scale = scale or D ** -0.5
    lib = _library()
    dq = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    dk = torch.empty((B, Sk, KH, D), dtype=q.dtype, device=q.device)
    dv = torch.empty((B, Sk, KH, D), dtype=q.dtype, device=q.device)
    err = lib.fa_backward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), dout.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), B, S, Sk, H, KH, D, float(scale), int(causal),
        int(window), *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *dout.stride()[:3], DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    _raise(lib, err, f"{NAME} backward")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale):
        out, lse = _forward(q, k, v, causal, window, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, window, scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        causal, window, scale = ctx.args
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout,
                                         causal=causal, window=window,
                                         scale=scale)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    scale: float = None) -> torch.Tensor:
    """Attention on the card, differentiable in q, k and v.  Returns a
    contiguous ``(B, S, H, D)``."""
    scale = scale or q.shape[-1] ** -0.5
    return _FlashAttention.apply(q, k, v, bool(causal), int(window),
                                 float(scale))


flash_attention.launches = 0
flash_attention_bwd.launches = 0
