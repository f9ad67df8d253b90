"""CUDA kernel: the QLoRA int4 matmul ``x @ dequant(packed, scales)``,
with its dx.

The port of the JAX package's Pallas kernel
``repro/kernels/int4_matmul.py::int4_matmul``.  The source, its design
and its bound are in ``csrc/int4_matmul.cu``; the plain versions it is
held to are ``ref.int4_matmul`` and ``ref.int4_matmul_t``, with the
same signatures.

The packed base weight (``peft.lora.quantize``: ``(K, N/2)`` uint8 and
``(K, N/qblock)`` float32 scales) is never dequantized whole: both entry
points of the kernel dequantize one tile of it at a time in shared
memory.  ``round_to`` picks the dequantized weight's precision,
``(nibble - 8) · scale`` in float32 or rounded to bf16 (the JAX model's
``dequantize`` default).

The JAX package trains through XLA's gradient of ``dequantize`` and an
einsum; here the gradient is a ``torch.autograd.Function`` whose dx is
the kernel's NT entry point, ``dy @ dequant(W)ᵀ``, reading the packed
rows in place.  The packed weight and its scales are frozen: asking for
their gradient raises.

Where the kernel splits a small grid's reduction, the wrapper allocates
its float32 workspace (``i4_workspace`` floats); the split's second pass
is part of the same launch and counts once.  These wrappers take CUDA
tensors only and launch the kernel or raise: they never fall back to
the plain version.  Given abstract tensors (``counts.is_abstract``)
they launch nothing: they allocate the output and the workspace and add
the launch's counts to the open tallies.  ``int4_matmul.launches``
counts forward (NN) launches and ``int4_matmul_t.launches`` the NT ones.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, counts

NAME = "int4_matmul"
SOURCE = "src/repro_torch/kernels/csrc/int4_matmul.cu"
REPLACES = "src/repro/kernels/int4_matmul.py:38"
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
ROUND_TO = {torch.float32: 0, torch.bfloat16: 1}

_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = build.load(NAME)
    lib.i4_matmul.argtypes = [_P] * 4 + [_I64] * 3 + [_I] * 4 + [_P, _P]
    lib.i4_matmul.restype = _I
    lib.i4_workspace.argtypes = [_I64] * 3 + [_I]
    lib.i4_workspace.restype = _I64
    lib.i4_error_string.argtypes = [_I]
    lib.i4_error_string.restype = ctypes.c_char_p
    return lib


def _launch(a, packed, scales, qblock: int, round_to, trans: bool):
    """One launch: NN ``a (M, K) → (M, N)`` or NT ``a (M, N) → (M, K)``
    for a packed ``(K, N/2)`` weight."""
    if counts.is_abstract(a):
        return _abstract_launch(a, packed, scales, qblock, trans)
    if a.dim() != 2 or packed.dim() != 2 or scales.dim() != 2:
        raise ValueError(f"int4_matmul takes 2-D operands, not "
                         f"{tuple(a.shape)}, {tuple(packed.shape)}, "
                         f"{tuple(scales.shape)}")
    K, N = packed.shape[0], 2 * packed.shape[1]
    if qblock < 2 or qblock % 2 or N % qblock:
        raise ValueError(f"qblock {qblock} must be even and divide N={N}")
    if tuple(scales.shape) != (K, N // qblock):
        raise ValueError(f"scales {tuple(scales.shape)} do not match "
                         f"packed {tuple(packed.shape)} at qblock {qblock}")
    if a.shape[1] != (N if trans else K):
        raise ValueError(f"{'dy' if trans else 'x'} {tuple(a.shape)} does "
                         f"not match the ({K}, {N}) weight")
    if a.dtype not in DTYPES:
        raise TypeError(f"int4_matmul takes float32 or bfloat16, "
                        f"not {a.dtype}")
    if packed.dtype != torch.uint8 or scales.dtype != torch.float32:
        raise TypeError(f"packed must be uint8 and scales float32, not "
                        f"{packed.dtype} and {scales.dtype}")
    if round_to not in ROUND_TO:
        raise TypeError(f"round_to must be float32 or bfloat16, "
                        f"not {round_to}")
    for name, t in (("a", a), ("packed", packed), ("scales", scales)):
        if not t.is_cuda or t.device != a.device:
            raise ValueError(f"{name} must lie on {a.device} (CUDA)")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if a.device.index != torch.cuda.current_device():
        raise ValueError(f"tensors lie on {a.device}, but the current "
                         f"device is {torch.cuda.current_device()}")
    lib = _library()
    M = a.shape[0]
    out = torch.empty((M, K if trans else N), dtype=a.dtype, device=a.device)
    n_ws = lib.i4_workspace(M, K, N, int(trans))
    ws = (torch.empty(n_ws, dtype=torch.float32, device=a.device)
          if n_ws else None)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = lib.i4_matmul(a.data_ptr(), packed.data_ptr(), scales.data_ptr(),
                        out.data_ptr(), M, K, N, int(qblock), int(trans),
                        ROUND_TO[round_to], DTYPES[a.dtype],
                        ws.data_ptr() if ws is not None else None, stream)
    if err:
        raise RuntimeError(f"{NAME} launch failed: "
                           f"{lib.i4_error_string(err).decode()}")
    if trans:
        int4_matmul_t.launches += 1
    else:
        int4_matmul.launches += 1
    return out


def _abstract_launch(a, packed, scales, qblock: int, trans: bool):
    """What ``_launch`` allocates, counted and not launched."""
    K, N = packed.shape[0], 2 * packed.shape[1]
    M = a.shape[0]
    out = torch.empty((M, K if trans else N), dtype=a.dtype, device=a.device)
    n_ws = counts.i4_workspace(M, K, N, trans)
    if n_ws:
        torch.empty(n_ws, dtype=torch.float32, device=a.device)
    counts.add(NAME + ("_t" if trans else ""),
               *counts.int4_flops_bytes(M, K, N, qblock))
    return out


class _Int4Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, packed, scales, qblock, round_to):
        ctx.save_for_backward(packed, scales)
        ctx.qblock, ctx.round_to = qblock, round_to
        return _launch(x.contiguous(), packed, scales, qblock, round_to,
                       trans=False)

    @staticmethod
    def backward(ctx, dy):
        packed, scales = ctx.saved_tensors
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            raise RuntimeError("int4_matmul: the packed base weight and "
                               "its scales are frozen and have no gradient")
        dx = None
        if ctx.needs_input_grad[0]:
            dx = _launch(dy.contiguous(), packed, scales, ctx.qblock,
                         ctx.round_to, trans=True)
        return dx, None, None, None, None


def int4_matmul(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor,
                qblock: int = 64, round_to=torch.float32) -> torch.Tensor:
    """``x (M, K) @ dequant(packed (K, N/2), scales (K, N/qblock))`` →
    ``(M, N)`` in x's dtype on the card, differentiable in x."""
    return _Int4Matmul.apply(x, packed, scales, int(qblock), round_to)


def int4_matmul_t(dy: torch.Tensor, packed: torch.Tensor,
                  scales: torch.Tensor, qblock: int = 64,
                  round_to=torch.float32) -> torch.Tensor:
    """``dy (M, N) @ dequant(packed, scales)ᵀ`` → ``(M, K)`` on the card:
    the NT entry point that ``int4_matmul``'s backward launches."""
    return _launch(dy.contiguous(), packed, scales, int(qblock), round_to,
                   trans=True)


int4_matmul.launches = 0
int4_matmul_t.launches = 0
