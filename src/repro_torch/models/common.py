"""Shared model utilities: norms, rotary embeddings, init, LoRA dense.

The port of ``repro/models/common.py``.  Activations carry the client
axis first: ``(C, ..., d)``.  Base weights are shared by every client and
never stacked; LoRA adapters are stacked ``(C, ...)``.  A QLoRA base
weight stays packed (``weight`` returns a ``QWeight``) and ``dense``
hands it to ``kernels.ops.int4_matmul`` as it is.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch import random as jr
from repro_torch.kernels import ops
from repro_torch.peft.lora import QBLOCK


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5
             ) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * scale.float()).to(dt)


def init_dense(key, shape, dtype=torch.float32, scale: Optional[float] = None,
               device="cpu") -> torch.Tensor:
    """Truncated-normal fan-in init, drawn on ``device``.  A leaf of more
    than ``random.DRAW_SLICE`` values is drawn a slice of its flat index
    at a time into a tensor of its final dtype: bitwise the whole draw
    (element ``i`` depends only on ``i``), with the draw's peak memory
    that of one slice."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    std = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    n = math.prod(shape)
    if n <= jr.DRAW_SLICE:
        return (jr.truncated_normal(key, -2.0, 2.0, tuple(shape), device)
                * std).to(dtype)
    out = torch.empty(n, dtype=dtype, device=device)
    for start in range(0, n, jr.DRAW_SLICE):
        m = min(jr.DRAW_SLICE, n - start)
        out[start:start + m] = (jr.truncated_normal(
            key, -2.0, 2.0, (m,), device, start=start) * std).to(dtype)
    return out.reshape(shape)


class QWeight(NamedTuple):
    """A QLoRA base weight ``(K, N)`` kept packed: ``packed`` ``(K, N/2)``
    uint8, ``scales`` ``(K, N/block)`` float32."""
    packed: torch.Tensor
    scales: torch.Tensor
    block: int

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.packed.shape[0], 2 * self.packed.shape[1])


def weight(params: dict, name: str) -> Union[torch.Tensor, QWeight]:
    """Resolve a base weight: the tensor ``name``, or for a QLoRA layer
    its ``{name}__q``/``{name}__s`` pair, left packed.  The JAX package
    dequantizes here (to bf16, per use); the port dequantizes inside the
    ``int4_matmul`` kernel, with the same bf16 rounding."""
    w = params.get(name)
    if w is not None:
        return w
    return QWeight(params[f"{name}__q"], params[f"{name}__s"], QBLOCK)


def dense(x: torch.Tensor, w: Union[torch.Tensor, QWeight],
          lora: Optional[Tuple[torch.Tensor, torch.Tensor, float]] = None
          ) -> torch.Tensor:
    """y = x @ w (+ LoRA path scale · (x @ A) @ B).

    ``x`` is ``(C, ..., K)`` and ``w`` the shared ``(K, N)``; with LoRA,
    A ``(C, K, r)`` and B ``(C, r, N)`` are per client, and the whole
    projection is one launch of ``kernels.ops.lora_matmul`` on the card.
    A packed ``QWeight`` goes to ``kernels.ops.int4_matmul`` with the
    client axis folded into the rows (the base is shared), dequantized
    as ``bf16(q·s)`` as the JAX model's ``dequantize`` gives it; the
    LoRA term is then two batched matmuls, as the JAX einsums leave it
    outside any kernel.
    """
    if isinstance(w, QWeight):
        return _qlora_dense(x, w, lora)
    w = w.to(x.dtype)
    if lora is None:
        return matmul(x, w)
    a, b, scale = lora
    C, K = x.shape[0], x.shape[-1]
    y = ops.lora_matmul(x.reshape(C, -1, K), w, a.to(x.dtype),
                        b.to(x.dtype), scale)
    return y.reshape(*x.shape[:-1], w.shape[1])


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in x's dtype.  On the CPU a bfloat16 product is taken in
    float32 and rounded once, as XLA computes it there; torch's own CPU
    bfloat16 matmul can carry a NaN of one row into another."""
    w = w.to(x.dtype)
    if x.device.type == "cpu" and x.dtype == torch.bfloat16:
        return (x.float() @ w.float()).to(x.dtype)
    return x @ w


def _qlora_dense(x, w: QWeight, lora) -> torch.Tensor:
    K, N = w.shape
    y = ops.int4_matmul(x.reshape(-1, K), w.packed, w.scales, w.block,
                        round_to=torch.bfloat16)
    if lora is None:
        return y.reshape(*x.shape[:-1], N)
    a, b, scale = lora
    C = x.shape[0]
    x3 = x.reshape(C, -1, K)
    y = y.reshape(C, -1, N) + scale * torch.bmm(torch.bmm(x3, a.to(x.dtype)),
                                                b.to(x.dtype))
    return y.reshape(*x.shape[:-1], N)


def lora_pair(params: dict, name: str, lora_cfg) -> Optional[Tuple]:
    """Fetch (A, B, scale) for target ``name`` if adapters exist."""
    a = params.get(f"{name}_lora_a")
    if a is None:
        return None
    return (a, params[f"{name}_lora_b"], lora_cfg.alpha / lora_cfg.rank)


def rope_freqs(head_dim: int, theta: float, sections: Tuple[int, ...] = (),
               device="cpu") -> torch.Tensor:
    """Per-pair inverse frequencies, shape (head_dim//2,).  Computed on
    the CPU, so every device sees the same values.

    With ``sections`` (M-RoPE, qwen2-vl) the pairs are split into
    temporal/height/width sections, each with its own ladder
    ``1/θ^(i·2/(2·sec))``, concatenated; with the scalar (text)
    positions the model gives, all three sections share the position
    index, as in the JAX package."""
    half = head_dim // 2
    if not sections:
        ex = torch.arange(half, dtype=torch.float32) * 2 / head_dim
        return (1.0 / (theta ** ex)).to(device)
    out = torch.cat([1.0 / (theta ** (torch.arange(sec, dtype=torch.float32)
                                      * 2 / (2 * sec)))
                     for sec in sections])
    assert out.shape[0] == half, (sections, head_dim)
    return out.to(device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               freqs: torch.Tensor, heads: bool = True) -> torch.Tensor:
    """x: ``(..., S, H, D)``, or ``(..., S, D)`` with ``heads=False``;
    positions: ``(S,)``.  Rotates the two halves of the last dim (not
    interleaved pairs)."""
    angles = positions.float()[:, None] * freqs                # (S, D/2)
    if heads:
        angles = angles[:, None, :]                            # (S, 1, D/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def swiglu(x: torch.Tensor) -> torch.Tensor:
    """Input is the fused (gate‖up) projection; returns silu(gate)*up."""
    gate, up = x.chunk(2, dim=-1)
    return F.silu(gate) * up
