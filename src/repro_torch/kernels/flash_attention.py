"""CUDA kernels: grouped-head flash attention, forward and backward.

The port of the JAX package's Pallas kernel
``repro/kernels/flash_attention.py::flash_attention``.  The source, its
design and its bound are in ``csrc/flash_attention.cu``; the plain
version it is held to is ``ref.flash_attention``, with the same
signature: q ``(B, S, H, D)``, k ``(B, Sk, KH, D)`` and v ``(B, Sk, KH,
Dv)`` in the model's layout, q-head ``h`` reading kv-head ``h // (H //
KH)``.  The kernel takes the head dims the configs use, ``HEAD_DIMS``;
a v head dim below q's (multi-head latent attention's 64 under 96) is
zero-padded to D here and the output sliced back: the zero columns of V
give exact zeros, the softmax scale stays ``D ** -0.5``, and autograd
carries the pad and the slice through the backward.

Every product runs on the tensor cores (TF32 ``mma.sync`` with the
error-compensated split of ``csrc/tf32x3.cuh``, float32-accurate).  The
forward takes 64 query rows of one q-head a CTA and stages each K/V
tile of 64 keys once, by ``cp.async``.  The JAX package trains through
the jnp chunked flash of ``models/attention.py``, so it has no backward
kernel; here the gradient is a ``torch.autograd.Function`` whose
backward computes dQ, dK and dV from the logsumexp the forward saves,
one CTA per 64 keys.  Up to 64 keys (the LLM-QFL Step 1's sequences)
that is one launch; above (the registry families' training, 128 to 1500
keys and beyond), a first launch computes rowsum(dO O) and a last one
sums the k-tiles' dQ slabs (a float32 workspace the wrapper allocates)
in a fixed order, so the backward is bitwise repeatable.

Each wrapper takes CUDA tensors only and launches its kernels or raises:
it never falls back to the plain version.  ``flash_attention.launches``
counts forward launches.  ``flash_attention_bwd.launches`` counts
backward calls, one each: a call is one launch up to 64 keys, three
above (``flash_attention_bwd.side_launches`` counts the two extra, the
rowsum(dO O) and dQ-sum passes).  Given abstract tensors
(``counts.is_abstract``) the wrappers launch nothing: they allocate what
a launch allocates (the output and ``lse``; ``dq``, ``dk``, ``dv`` and
the backward's workspace) and add its counts to the open tallies.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, counts

NAME = "flash_attention"
SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"
REPLACES = "src/repro/kernels/flash_attention.py:68"
HEAD_DIMS = (32, 48, 64, 80, 96, 112, 128)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib`` with the argument and result types of the C interface."""
    dims = [_I] * 6 + [ctypes.c_float, _I, _I]
    lib.fa_forward.argtypes = [_P] * 5 + dims + [_I64] * 9 + [_I, _P]
    lib.fa_forward.restype = _I
    lib.fa_backward.argtypes = [_P] * 9 + dims + [_I64] * 12 + [_I, _P, _P]
    lib.fa_backward.restype = _I
    lib.fa_backward_workspace.argtypes = [_I] * 5
    lib.fa_backward_workspace.restype = _I64
    lib.fa_error_string.argtypes = [_I]
    lib.fa_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    return declare(build.load(NAME))


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
        raise ValueError(
            f"head dim {D} not in {HEAD_DIMS}: the kernel takes no other")
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
        if not _rows_aligned(t):
            raise ValueError("every row must start on 16 bytes "
                             "(the kernels stage rows by cp.async)")
    if q.device.index != torch.cuda.current_device():
        raise ValueError(f"tensors lie on {q.device}, but the current "
                         f"device is {torch.cuda.current_device()}")


def _rows_aligned(t) -> bool:
    """Does every (b, s, h) row of ``t`` start on 16 bytes?"""
    return t.data_ptr() % 16 == 0 and all(
        st * t.element_size() % 16 == 0 for st in t.stride()[:-1])


def _aligned(t):
    if counts.is_abstract(t):      # no address: the allocator's 16 bytes
        ok = all(st * t.element_size() % 16 == 0
                 for st in (t.storage_offset(),) + t.stride()[:-1])
        return t if ok else t.contiguous()
    return t if _rows_aligned(t) else t.contiguous()


def _raise(lib, err, what):
    if err:
        raise RuntimeError(f"{what} launch failed: "
                           f"{lib.fa_error_string(err).decode()}")


def _forward(q, k, v, causal: bool, window: int, scale: float):
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    B, S, H, D = q.shape
    Sk, KH = k.shape[1], k.shape[2]
    if counts.is_abstract(q):
        out = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
        lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
        counts.add(NAME, *counts.attn_flops_bytes(
            B, S, H, KH, D, elem=q.element_size(), Sk=Sk, causal=causal,
            window=window))
        return out, lse
    _check(q, k, v)
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
    q, k, v, dout = _aligned(q), _aligned(k), _aligned(v), _aligned(dout)
    B, S, H, D = q.shape
    Sk, KH = k.shape[1], k.shape[2]
    if counts.is_abstract(q):
        return _abstract_backward(q, k, causal, window)
    _check(q, k, v, out, dout)
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
    nbytes = lib.fa_backward_workspace(B, S, Sk, H, D)
    work = torch.empty(nbytes, dtype=torch.uint8, device=q.device) \
        if nbytes else None
    err = lib.fa_backward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), dout.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), B, S, Sk, H, KH, D, float(scale), int(causal),
        int(window), *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *dout.stride()[:3], DTYPES[q.dtype],
        work.data_ptr() if work is not None else None,
        torch.cuda.current_stream(q.device).cuda_stream)
    _raise(lib, err, f"{NAME} backward")
    flash_attention_bwd.launches += 1
    if nbytes:
        flash_attention_bwd.side_launches += 2
    return dq, dk, dv


def _abstract_backward(q, k, causal: bool, window: int):
    """What ``flash_attention_bwd`` allocates, counted and not launched."""
    B, S, H, D = q.shape
    Sk, KH = k.shape[1], k.shape[2]
    dq = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    dk = torch.empty((B, Sk, KH, D), dtype=q.dtype, device=q.device)
    dv = torch.empty((B, Sk, KH, D), dtype=q.dtype, device=q.device)
    nbytes = counts.fa_backward_workspace(B, S, Sk, H, D)
    if nbytes:
        torch.empty(nbytes, dtype=torch.uint8, device=q.device)
    counts.add(NAME + "_bwd", *counts.attn_flops_bytes(
        B, S, H, KH, D, backward=True, elem=q.element_size(), Sk=Sk,
        causal=causal, window=window))
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
    contiguous ``(B, S, H, Dv)``; a v narrower than q is zero-padded to
    q's head dim for the kernel."""
    D, Dv = q.shape[-1], v.shape[-1]
    scale = scale or D ** -0.5
    if Dv > D:
        raise ValueError(f"v head dim {Dv} exceeds q's {D}")
    if Dv < D:
        v = torch.nn.functional.pad(v, (0, D - Dv))
    out = _FlashAttention.apply(q, k, v, bool(causal), int(window),
                                float(scale))
    return out if Dv == D else out[..., :Dv].contiguous()


flash_attention.launches = 0
flash_attention_bwd.launches = 0
flash_attention_bwd.side_launches = 0
