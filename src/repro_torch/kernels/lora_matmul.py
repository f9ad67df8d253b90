"""CUDA kernel: batched LoRA projection ``y = x@W + s·(x@A)@B``, with its
backward.

The port of the JAX package's Pallas kernel
``repro/kernels/lora_matmul.py::lora_matmul``.  The source, its design
and its bound are in ``csrc/lora_matmul.cu``; the plain version it is
held to is ``ref.lora_matmul``, with the same signature.

The JAX package trains through ``models/common.dense``'s einsums, so it
has no backward kernel; here the gradient is a ``torch.autograd.Function``:

  - ``dx = dy@Wᵀ + s·(dy@Bᵀ)@Aᵀ`` is the same kernel on transposed
    views (the kernel reads every operand through its strides),
    skipped when ``x`` needs no gradient,
  - ``dA = s·xᵀ(dy@Bᵀ)`` and ``dB = s·(x@A)ᵀdy`` are library matmuls, as
    ``jax.grad`` leaves them to XLA outside any Pallas kernel, one
    product a client: a batched product lets the library pick its
    kernel and reduction split by the client count, and AdamW's first
    step turns each element's rounding into ±lr, so a client's step
    would depend on the clients beside it,
  - W is frozen: asking for its gradient raises.

Where the kernel splits a small grid's reduction, the wrapper allocates
its float32 workspace (``lm_workspace`` floats); the split's second pass
is part of the same launch and counts once.  This wrapper takes CUDA
tensors only and launches the kernel or raises: it never falls back to
the plain version.  Given abstract tensors (``counts.is_abstract``) it
launches nothing: it allocates the output and the workspace and adds
the launch's counts to the open tallies (``counts.tally``).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, counts

NAME = "lora_matmul"
SOURCE = "src/repro_torch/kernels/csrc/lora_matmul.cu"
REPLACES = "src/repro/kernels/lora_matmul.py:37"
MAX_RANK = 32
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I64 = ctypes.c_void_p, ctypes.c_longlong


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = build.load(NAME)
    fn = lib.lm_lora_matmul
    fn.argtypes = ([_P] * 5 + [_I64] * 4 + [ctypes.c_int, ctypes.c_float]
                   + [_I64] * 11 + [ctypes.c_int, _P, _P])
    fn.restype = ctypes.c_int
    lib.lm_workspace.argtypes = [_I64] * 4 + [ctypes.c_int]
    lib.lm_workspace.restype = _I64
    lib.lm_error_string.argtypes = [ctypes.c_int]
    lib.lm_error_string.restype = ctypes.c_char_p
    return lib


def _launch(x, w, a, b, scale: float) -> torch.Tensor:
    """One launch on ``(C, M, K)``, ``(K, N)``, ``(C, K, r)``, ``(C, r, N)``
    tensors of any strides; returns a contiguous ``(C, M, N)``."""
    if counts.is_abstract(x):
        return _abstract_launch(x, w, a, b)
    C, M, K = x.shape
    N = w.shape[1]
    r = a.shape[2]
    for name, t in (("x", x), ("w", w), ("a", a), ("b", b)):
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"{name} must lie on {x.device} (CUDA)")
        if t.dtype != x.dtype:
            raise TypeError(f"{name} is {t.dtype}, x is {x.dtype}")
    if x.dtype not in DTYPES:
        raise TypeError(f"lora_matmul takes float32 or bfloat16, "
                        f"not {x.dtype}")
    if (tuple(w.shape) != (K, N) or tuple(a.shape) != (C, K, r)
            or tuple(b.shape) != (C, r, N)):
        raise ValueError(f"shapes x {tuple(x.shape)}, w {tuple(w.shape)}, "
                         f"a {tuple(a.shape)}, b {tuple(b.shape)} disagree")
    if not 1 <= r <= MAX_RANK:
        raise ValueError(f"LoRA rank {r} outside [1, {MAX_RANK}]")
    if x.device.index != torch.cuda.current_device():
        raise ValueError(f"tensors lie on {x.device}, but the current "
                         f"device is {torch.cuda.current_device()}")
    lib = _library()
    y = torch.empty((C, M, N), dtype=x.dtype, device=x.device)
    n_ws = lib.lm_workspace(C, M, N, K, r)
    ws = (torch.empty(n_ws, dtype=torch.float32, device=x.device)
          if n_ws else None)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.lm_lora_matmul(
        x.data_ptr(), w.data_ptr(), a.data_ptr(), b.data_ptr(),
        y.data_ptr(), C, M, N, K, r, float(scale),
        *x.stride(), *w.stride(), *a.stride(), *b.stride(),
        DTYPES[x.dtype], ws.data_ptr() if ws is not None else None,
        stream)
    if err:
        raise RuntimeError(f"{NAME} launch failed: "
                           f"{lib.lm_error_string(err).decode()}")
    lora_matmul.launches += 1
    return y


def _abstract_launch(x, w, a, b) -> torch.Tensor:
    """What ``_launch`` allocates, counted and not launched."""
    C, M, K = x.shape
    N, r = w.shape[1], a.shape[2]
    y = torch.empty((C, M, N), dtype=x.dtype, device=x.device)
    n_ws = counts.lm_workspace(C, M, N, K, r)
    if n_ws:
        torch.empty(n_ws, dtype=torch.float32, device=x.device)
    counts.add(NAME, *counts.lora_flops_bytes(C, M, K, N, r,
                                              elem=x.element_size()))
    return y


class _LoRAMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, a, b, scale):
        ctx.save_for_backward(x, w, a, b)
        ctx.scale = scale
        return _launch(x, w, a, b, scale)

    @staticmethod
    def backward(ctx, dy):
        x, w, a, b = ctx.saved_tensors
        s = ctx.scale
        if ctx.needs_input_grad[1]:
            raise RuntimeError("lora_matmul: the base weight W is frozen "
                               "and has no gradient")
        dx = da = db = None
        if ctx.needs_input_grad[0]:
            dx = _launch(dy, w.t(), b.transpose(1, 2), a.transpose(1, 2), s)
        C = x.shape[0]
        if ctx.needs_input_grad[2]:
            da = s * torch.stack([x[c].t() @ (dy[c] @ b[c].t())
                                  for c in range(C)])
        if ctx.needs_input_grad[3]:
            db = s * torch.stack([(x[c] @ a[c]).t() @ dy[c]
                                  for c in range(C)])
        return dx, None, da, db, None


def lora_matmul(x: torch.Tensor, w: torch.Tensor, a: torch.Tensor,
                b: torch.Tensor, scale: float) -> torch.Tensor:
    """``x@W + scale·(x@A)@B`` on the card, differentiable in x, A, B.

    Batched: x ``(C, M, K)``, W ``(K, N)``, A ``(C, K, r)``, B
    ``(C, r, N)`` → ``(C, M, N)``; or unbatched 2-D operands → ``(M, N)``.
    """
    if x.dim() == 2:
        return _LoRAMatmul.apply(x[None], w, a[None], b[None],
                                 float(scale))[0]
    return _LoRAMatmul.apply(x, w, a, b, float(scale))


lora_matmul.launches = 0
