"""XLA's float32 ``sin`` and ``cos`` on the CPU, in torch, on any device.

XLA's CPU backend lowers a float32 ``sin`` or ``cos`` to a call of the C
library's ``sinf`` / ``cosf`` (its object code imports the symbol), so
under the reference's jax on glibc 2.36 (x86-64, whose ``sinf`` takes
the FMA build on a CPU with FMA) the gate angles' sines and cosines are
glibc's.  That algorithm (ARM's optimized routines,
``sysdeps/ieee754/flt-32/s_sinf.c``) works in double precision:

- ``|y| < 120``: one quadrant ``n`` from ``y·(2/π)·2**24`` truncated to an
  int32 (plus half a quadrant, shifted down by 24), then ``r = y − n·π/2``
  as one fused multiply-add;
- ``|y| >= 120``: ``n`` and ``r`` from 4/π to 192 bits
  (``_INV_PIO4``) in 64-bit integer arithmetic, ``r = int64 · π·2**-62``;
- then a degree-7 odd (sine) or degree-8 even (cosine) polynomial in
  ``r``, its multiply-adds fused, chosen and signed by ``n``'s quadrant,
  and one rounding to float32.  ``|y| < 2**-12`` gives ``y`` (sine) or
  1 (cosine).

The constants are glibc's ``__sincosf_table`` and ``__inv_pio4``.  The
fused reduction is exact in two unfused steps (``_HPI_HI`` holds π/2's
top 46 bits, so ``n·_HPI_HI`` and ``y − n·_HPI_HI`` are exact for
``|n| < 2**7``).  The polynomial's fused multiply-adds are emulated in
double (``_fma64``: Dekker's exact product, then Knuth's exact sum).
The emulation makes no host read and no copy from pageable host
memory, so a CUDA graph can capture it.

``csrc/xla_sincos.cuh``'s ``xla_sincosf`` is the same algorithm on the
card, its fused steps ``__fma_rn`` and every other step an explicit
round-to-nearest intrinsic: the tape kernel takes it for its gate
matrices, so it stays bitwise its plain version (``kernels/ref.py``,
which takes ``plain_sincos``), and ``sincos`` launches it elementwise
(``kernels/xla_sincos.py``) for a CUDA tensor.
``tests/test_torch_xla_trig.py`` holds the plain version to ``jnp.sin``
/ ``jnp.cos`` bitwise; ``tests/test_torch_cuda_trig.py`` the kernels to
it.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.xla_sincos import xla_sincos

_H = float.fromhex
_HPI_INV = _H("0x1.45f306dc9c883p+23")      # 2/π · 2**24
_HPI = _H("0x1.921fb54442d18p+0")           # π/2
_HPI_HI = _H("0x1.921fb54442d00p+0")        # its top 46 bits
_HPI_LO = _HPI - _HPI_HI
_PI63 = _H("0x1.921fb54442d18p-62")         # 2π · 2**-64
_C = (1.0, _H("-0x1.ffffffd0c621cp-2"), _H("0x1.55553e1068f19p-5"),
      _H("-0x1.6c087e89a359dp-10"), _H("0x1.99343027bf8c3p-16"))
_S = (_H("-0x1.555545995a603p-3"), _H("0x1.1107605230bc4p-7"),
      _H("-0x1.994eb3774cf24p-13"))
_INV_PIO4 = (
    0xa2, 0xa2f9, 0xa2f983, 0xa2f9836e, 0xf9836e4e, 0x836e4e44, 0x6e4e4415,
    0x4e441529, 0x441529fc, 0x1529fc27, 0x29fc2757, 0xfc2757d1, 0x2757d1f5,
    0x57d1f534, 0xd1f534dd, 0xf534ddc0, 0x34ddc0db, 0xddc0db62, 0xc0db6295,
    0xdb629599, 0x6295993c, 0x95993c43, 0x993c4390, 0x3c439041)
# top 12 bits of |y|'s float32 pattern: 2**-12, 120
_TINY, _FAST = 0x398, 0x42f
_SPLIT = 134217729.0                         # 2**27 + 1, Veltkamp's split


def _split(v):
    """Veltkamp's split of a double (a tensor or a float): ``v = hi + lo``,
    each with at most 26 significant bits."""
    t = _SPLIT * v
    hi = t - (t - v)
    return hi, v - hi


def _fma64(a: torch.Tensor, b, c: torch.Tensor) -> torch.Tensor:
    """Double ``a·b + c`` rounded once: Dekker's exact product ``p + e``
    (``b`` a tensor or a float, split on the host), Knuth's exact sum
    with ``c``, then the two error terms.  Creates no tensor from host
    data, so it runs under CUDA graph capture."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    s = p + c
    bp = s - p
    t = (p - (s - bp)) + (c - bp)
    return s + (t + e)


def _polys(r: torch.Tensor):
    """``(sinpoly(r), cospoly(r))`` in double, as glibc's ``sinf_poly``
    for an even and an odd quadrant (table 0), each multiply-add
    fused."""
    f = _fma64
    x2 = r * r
    x3 = r * x2
    s1 = f(x2, _S[2], torch.full_like(r, _S[1]))
    x7 = x3 * x2
    s = f(x3, _S[0], r)
    sp = f(x7, s1, s)
    x4 = x2 * x2
    c2 = f(x2, _C[4], torch.full_like(r, _C[3]))
    c1 = f(x2, _C[1], torch.full_like(r, _C[0]))
    x6 = x4 * x2
    c = f(x4, _C[2], c1)
    cp = f(x6, c2, c)
    return sp, cp


_PINNED = []


def _table(device) -> torch.Tensor:
    """``_INV_PIO4`` as int64 on ``device``: on the card copied from a
    pinned host tensor made once, as CUDA graph capture allows."""
    if device.type != "cuda":
        return torch.tensor(_INV_PIO4, dtype=torch.int64)
    if not _PINNED:
        _PINNED.append(torch.tensor(_INV_PIO4, dtype=torch.int64)
                       .pin_memory())
    return _PINNED[0].to(device, non_blocking=True)


def _reduce_large(bits: torch.Tensor):
    """glibc's ``reduce_large`` on ``|y|``'s float32 bits (int64 holding
    uint32): ``(r, n)``; uint64 arithmetic in int64's wrapping bits."""
    tab = _table(bits.device)
    idx = (bits >> 26) & 15
    shift = (bits >> 23) & 7
    m = ((bits & 0xffffff) | 0x800000) << shift
    res0 = (m * tab[idx]) & 0xffffffff
    res1 = m * tab[idx + 4]
    res2 = m * tab[idx + 8]
    res0 = ((res2 >> 32) & 0xffffffff) | (res0 << 32)
    res0 = res0 + res1
    n = ((res0 + (1 << 61)) >> 62) & 3
    res0 = res0 - (n << 62)
    return res0.double() * _PI63, n


def sincos(y: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """XLA's float32 ``(sin(y), cos(y))`` on the CPU, for ``y`` taken as
    float32: on the card one launch of the hand-written kernel
    (``kernels/xla_sincos.py``), elsewhere ``plain_sincos``."""
    if y.is_cuda:
        return xla_sincos(y)
    return plain_sincos(y)


def plain_sincos(y: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``sincos`` in torch operations, on any device: the plain version
    the card's kernel is held to (see the module docstring)."""
    y = y.float()
    bits = y.view(torch.int32).long() & 0x7fffffff          # |y|'s bits
    top = bits >> 20
    neg = y < 0
    x = y.double()
    # |y| < 120: truncation toward zero, as C's (int32_t) cast
    n = ((x * _HPI_INV).to(torch.int32) + 0x800000) >> 24
    nd = n.double()
    r = (x - nd * _HPI_HI) - nd * _HPI_LO
    big = (top >= _FAST) & torch.isfinite(y)
    # |y| >= 120: reduced from |y|; sin is odd and cos even there
    rl, nl = _reduce_large(torch.where(big, bits, torch.zeros_like(bits)))
    r = torch.where(big, rl, r)
    n = torch.where(big, nl.to(torch.int32), n)
    q = (n & 3).long()
    sp, cp = _polys(r)
    # quadrant q: sin = (P_s, P_c, -P_s, -P_c)[q], cos = (P_c, -P_s, -P_c, P_s)[q]
    odd = (q & 1) == 1
    flip_s = q >= 2
    flip_c = (q == 1) | (q == 2)
    s_val = torch.where(odd, cp, sp)
    c_val = torch.where(odd, sp, cp)
    s_val = torch.where(flip_s, -s_val, s_val).float()
    c_val = torch.where(flip_c, -c_val, c_val).float()
    s_val = torch.where(big & neg, -s_val, s_val)
    tiny = top < _TINY
    s_val = torch.where(tiny, y, s_val)
    c_val = torch.where(tiny, torch.ones_like(y), c_val)
    bad = ~torch.isfinite(y)
    nan = torch.full_like(y, float("nan"))
    return torch.where(bad, nan, s_val), torch.where(bad, nan, c_val)


def sin(y: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``sin`` on the CPU (``sincos``)."""
    return sincos(y)[0]


def cos(y: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``cos`` on the CPU (``sincos``)."""
    return sincos(y)[1]


def expi(y: torch.Tensor) -> torch.Tensor:
    """``exp(1j·y)`` as XLA computes it for a real float32 ``y`` cast to
    complex64: ``cos(y) + 1j·sin(y)``."""
    s, c = sincos(y)
    return torch.complex(c, s)
