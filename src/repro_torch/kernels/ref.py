"""Plain PyTorch versions of the port's kernels (the correctness contract).

Each function here is the definition its hand-written CUDA kernel is
held to on the card (``chip_smoke.py``), and what the kernel's dispatch
(``kernels/ops.py``) runs for a tensor on the CPU.  Each mirrors its
counterpart in the JAX package's ``kernels/ref.py`` and is tested against
it on identical inputs (``tests/test_torch_kernels.py``).
"""
from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from repro_torch.peft.lora import dequantize

# gate kinds of a compiled tape (``quantum.tape``): every gate is one
# (optionally controlled) 2×2 unitary
GATE_H, GATE_P, GATE_RY, GATE_RZ, GATE_X = 0, 1, 2, 3, 4

# 1/sqrt(2) in float32, the Hadamard entry of the JAX package's matrix
_H = float(np.float32(1) / np.sqrt(np.float32(2)))


@functools.lru_cache(maxsize=None)
def pair_indices(target: int, control: int, n_qubits: int,
                 device="cpu") -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """Index pairs (amp with target bit 0, partner) + control mask.

    Qubit ``q`` is bit ``n-1-q`` of the big-endian flat index.  Returns
    ``(idx0, idx1)`` each ``(2**n / 2,)`` int64 and ``cmask``
    ``(2**n / 2,)`` float32 — 1.0 where the gate acts (control bit set,
    or no control, ``control < 0``).  Results are cached and shared
    (the plain path replays every gate of a tape per evaluation): treat
    them as read-only.
    """
    half = (1 << n_qubits) // 2
    shift = n_qubits - 1 - target
    stride = 1 << shift
    k = torch.arange(half, dtype=torch.int64, device=device)
    idx0 = ((k >> shift) << (shift + 1)) | (k & (stride - 1))
    idx1 = idx0 | stride
    if control < 0:
        cmask = torch.ones(half, device=device)
    else:
        cmask = ((idx0 >> (n_qubits - 1 - control)) & 1).float()
    return idx0, idx1, cmask


def statevector_gate(psi_re: torch.Tensor, psi_im: torch.Tensor,
                     g_re: torch.Tensor, g_im: torch.Tensor,
                     target: int, control: int, n_qubits: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched controlled 2×2 gate on split-plane statevectors.

    psi: ``(B, 2**n)`` float32 re/im planes; g: ``(B, 2, 2)`` re/im
    planes, one gate per row; the gate acts on qubit ``target``, only
    where qubit ``control`` is set (``control < 0``: everywhere).
    Returns the new ``(re, im)`` planes: gather the pairs, complex 2×2
    mat-vec, ``cmask`` blend, scatter.
    """
    idx0, idx1, cmask = pair_indices(target, control, n_qubits,
                                     psi_re.device)
    a0r, a0i = psi_re[:, idx0], psi_im[:, idx0]
    a1r, a1i = psi_re[:, idx1], psi_im[:, idx1]
    g00r, g01r = g_re[:, 0, 0, None], g_re[:, 0, 1, None]
    g10r, g11r = g_re[:, 1, 0, None], g_re[:, 1, 1, None]
    g00i, g01i = g_im[:, 0, 0, None], g_im[:, 0, 1, None]
    g10i, g11i = g_im[:, 1, 0, None], g_im[:, 1, 1, None]
    # complex products associate as (g·a0) + (g·a1), as in the oracle
    n0r = (g00r * a0r - g00i * a0i) + (g01r * a1r - g01i * a1i)
    n0i = (g00r * a0i + g00i * a0r) + (g01r * a1i + g01i * a1r)
    n1r = (g10r * a0r - g10i * a0i) + (g11r * a1r - g11i * a1i)
    n1i = (g10r * a0i + g10i * a0r) + (g11r * a1i + g11i * a1r)
    m = cmask[None, :]
    out_re, out_im = psi_re.clone(), psi_im.clone()
    out_re[:, idx0] = m * n0r + (1.0 - m) * a0r
    out_im[:, idx0] = m * n0i + (1.0 - m) * a0i
    out_re[:, idx1] = m * n1r + (1.0 - m) * a1r
    out_im[:, idx1] = m * n1i + (1.0 - m) * a1i
    return out_re, out_im


def gate_planes(gate_id: torch.Tensor, angles: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """All gates' matrices for a batch: gate ids ``(G,)`` and angles
    ``(B, G)`` → re/im planes ``(G, B, 2, 2)``, one contiguous
    ``(B, 2, 2)`` block per gate.

    The values are the JAX package's ``_mat_*``: P = diag(1, e^{iθ}),
    RY(θ) = [[c, −s], [s, c]] and RZ(θ) = diag(e^{−iθ/2}, e^{iθ/2}) with
    c, s = cos(θ/2), sin(θ/2), H and X constant.
    """
    gid = gate_id[:, None]                                   # (G, 1)
    ang = angles.T                                           # (G, B)
    ch, sh = torch.cos(ang / 2), torch.sin(ang / 2)
    cf, sf = torch.cos(ang), torch.sin(ang)
    zero = torch.zeros_like(ang)
    is_h, is_p = gid == GATE_H, gid == GATE_P
    is_ry, is_rz, is_x = gid == GATE_RY, gid == GATE_RZ, gid == GATE_X
    w = torch.where
    g00r = w(is_h, _H, w(is_p, 1.0, w(is_ry | is_rz, ch, zero)))
    g01r = w(is_h, _H, w(is_ry, -sh, w(is_x, 1.0, zero)))
    g10r = w(is_h, _H, w(is_ry, sh, w(is_x, 1.0, zero)))
    g11r = w(is_h, -_H, w(is_p, cf, w(is_ry | is_rz, ch, zero)))
    g00i = w(is_rz, -sh, zero)
    g11i = w(is_p, sf, w(is_rz, sh, zero))
    G, B = ang.shape
    g_re = torch.stack([g00r, g01r, g10r, g11r], -1).view(G, B, 2, 2)
    g_im = torch.stack([g00i, zero, zero, g11i], -1).view(G, B, 2, 2)
    return g_re, g_im


def statevector_tape(angles: torch.Tensor, gate_id: torch.Tensor,
                     target, control, n_qubits: int,
                     gate=statevector_gate
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Replay a gate tape on |0…0⟩ for a batch: angles ``(B, G)``, the
    tape's columns ``(G,)`` → statevector planes ``(re, im)``, each
    ``(B, 2**n)`` float32.

    ``gate_planes``, then one ``gate`` a row of the tape, in order:
    ``statevector_gate`` here (the plain version), or the per-gate
    kernel's dispatch, which ``quantum.tape.run_tape`` takes above the
    tape kernel's size limit.  ``target`` and ``control`` may be tensors
    or arrays; they are read to the host.
    """
    B = angles.shape[0]
    g_re, g_im = gate_planes(gate_id, angles)
    psi_re = torch.zeros((B, 1 << n_qubits), device=angles.device)
    psi_re[:, 0] = 1.0
    psi_im = torch.zeros_like(psi_re)
    for gi, (t, c) in enumerate(zip(target.tolist(), control.tolist())):
        psi_re, psi_im = gate(psi_re, psi_im, g_re[gi], g_im[gi], t, c,
                              n_qubits)
    return psi_re, psi_im


def lora_matmul(x: torch.Tensor, w: torch.Tensor, a: torch.Tensor,
                b: torch.Tensor, scale: float) -> torch.Tensor:
    """y = x @ W + scale · (x @ A) @ B, accumulated in float32.

    Batched over clients: x ``(C, M, K)``, a shared W ``(K, N)``, A
    ``(C, K, r)`` and B ``(C, r, N)`` give ``(C, M, N)``; the unbatched
    2-D form is the JAX oracle's.  Its gradient is plain autograd.
    """
    xf = x.float()
    y = xf @ w.float()
    y = y + scale * ((xf @ a.float()) @ b.float())
    return y.to(x.dtype)


def int4_matmul(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor,
                block: int, round_to=torch.float32) -> torch.Tensor:
    """y = x @ dequant(packed, scales), accumulated in float32: the QLoRA
    base-weight path.

    x ``(M, K)``, packed ``(K, N/2)`` uint8, scales ``(K, N/block)``
    float32 → ``(M, N)`` in x's dtype.  Each weight is ``(nibble - 8) ·
    scale`` in float32, rounded to ``round_to``: float32 is the JAX
    oracle's contract, bfloat16 the JAX model's (``common.weight``
    dequantizes to bf16).  Differentiable in x by plain autograd.
    """
    w = dequantize(packed, scales, block, dtype=round_to).float()
    return (x.float() @ w).to(x.dtype)


def int4_matmul_t(dy: torch.Tensor, packed: torch.Tensor,
                  scales: torch.Tensor, block: int,
                  round_to=torch.float32) -> torch.Tensor:
    """dx = dy @ dequant(packed, scales)ᵀ: dy ``(M, N)`` → ``(M, K)`` in
    dy's dtype, the backward of ``int4_matmul`` with respect to x."""
    w = dequantize(packed, scales, block, dtype=round_to).float()
    return (dy.float() @ w.t()).to(dy.dtype)


def distill_kl(teacher_probs: torch.Tensor, student_logits: torch.Tensor,
               eps: float = 1e-9) -> torch.Tensor:
    """Per-row KL(P_t ‖ softmax(z)), ``(B, C), (B, C) → (B,)`` float32,
    with the teacher clipped to ``[eps, 1]``: the fused softmax + KL
    contract."""
    pt = torch.clamp(teacher_probs.float(), eps, 1.0)
    logq = torch.log_softmax(student_logits.float(), dim=-1)
    return torch.sum(pt * (torch.log(pt) - logq), dim=-1)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    scale: float = None) -> torch.Tensor:
    """Reference attention in the model's layout, with grouped heads.

    q ``(B, S, H, D)``, k ``(B, Sk, KH, D)``, v ``(B, Sk, KH, Dv)``:
    q-head ``h`` reads kv-head ``h // (H // KH)``, so with ``KH == H``
    this is the JAX oracle on GQA-expanded K/V, transposed; ``Dv`` may
    differ from ``D``, as in the JAX model's jnp flash.  Key ``kpos`` is attendable
    from ``qpos`` iff ``kpos <= qpos`` (causal) and ``qpos - kpos <
    window`` (window > 0).  Returns ``(B, S, H, Dv)``; the gradient is
    plain autograd.
    """
    B, S, H, D = q.shape
    Sk, KH = k.shape[1], k.shape[2]
    G = H // KH
    scale = scale or D ** -0.5
    qf = q.float().transpose(1, 2)                          # (B, H, S, D)
    kf = k.float().transpose(1, 2).repeat_interleave(G, dim=1)
    vf = v.float().transpose(1, 2).repeat_interleave(G, dim=1)
    logits = (qf @ kf.transpose(-1, -2)) * scale
    qpos = torch.arange(S, device=q.device)[:, None]
    kpos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones(S, Sk, dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos >= kpos
    if window:
        mask &= (qpos - kpos) < window
    logits = logits.masked_fill(~mask, -torch.inf)
    p = torch.softmax(logits, dim=-1)
    return (p @ vf).transpose(1, 2).to(q.dtype)
