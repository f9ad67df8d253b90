"""Threefry-2x32 keys: ``PRNGKey``, ``split``, ``fold_in``, ``uniform``,
``randint``, ``permutation``, ``choice``, ``normal``,
``truncated_normal``, ``gumbel`` and ``categorical``.

Bit-for-bit the draws of ``jax.random`` with the default threefry
implementation and ``jax_threefry_partitionable=True`` (the default from
jax 0.5 on), so the port can consume the JAX package's key contracts
(initial θ, ``eval_key``, ``llm_key``) and reproduce its runs draw for
draw.

A key is a ``(2,)`` numpy ``uint32`` array, exactly the contents of a
raw JAX key.  Keys and the handful of values drawn from them are tiny
host values, so everything here is numpy ``uint32`` arithmetic, whose
wrap-around is the hash's own; ``uniform`` returns a numpy float32 array
that the caller moves to its device.

``uniform_stack`` draws the finite-shot uniforms of a whole batch of
evaluations at once, one key a row, in torch on the caller's device:
row ``i`` is bitwise ``uniform(keys[i], shape, dtype)``.  Its keys, and
``fold_in``'s, may also be a tensor already on the device (int32 words
holding the uint32 bits), so a run whose keys were staged once draws
with no copy from the host.

``normal`` and ``truncated_normal`` draw weights, up to tens of millions
of values at a time, so they run in torch on the caller's device: the
same hash on int32 words (uint32 arithmetic's bits), then XLA's float32
``erf_inv`` (Giles' polynomial) over XLA's CPU ``log1p`` and ``log``
(Cephes' forms), every multiply-add fused as XLA fuses it.  Each step is
an IEEE operation that rounds the same on any device, so a draw is the
same on the CPU and on the card.  Against ``jax.random`` they are
bitwise equal on at least 99.9 % of values and within 2 ulp on all
(``tests/test_torch_random.py``).  Element ``i`` of a draw depends only
on the key and ``i`` (its counter is the flat index, split into high
and low words), so ``truncated_normal(..., start=s)`` draws elements
``[s, s + n)`` of the whole draw alone, bitwise: a leaf larger than
memory allows at once is drawn a slice at a time
(``models.common.init_dense``, slices of ``DRAW_SLICE``).  ``gumbel`` and ``categorical`` (the
serving entry point's sampler) take the same route: jax 0.9's default
``mode="low"`` draw ``-log(-log(u))`` through the same ``log``.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import numpy as np
import torch

_U32 = np.uint32
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = _U32(0x1BD11BDA)


def _rotl(v: np.ndarray, r: int) -> np.ndarray:
    return (v << _U32(r)) | (v >> _U32(32 - r))


def threefry2x32(key: np.ndarray, x0: np.ndarray, x1: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """The Threefry-2x32 block cipher (20 rounds) on counter pairs.  A
    stack of keys ``(..., 2)`` broadcasts against the counters."""
    key = np.asarray(key, _U32)
    k0, k1 = key[..., 0], key[..., 1]
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    with np.errstate(over="ignore"):
        x0 = np.asarray(x0, _U32) + ks[0]
        x1 = np.asarray(x1, _U32) + ks[1]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x0 = x0 + x1
                x1 = _rotl(x1, r) ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + _U32(i + 1)
    return x0, x1


def PRNGKey(seed: int) -> np.ndarray:
    """Raw key of an integer seed: ``[seed >> 32, seed & 0xFFFFFFFF]``
    of the seed as a 32-bit integer (JAX runs with x64 off)."""
    seed = int(seed)
    if not -(1 << 31) <= seed < (1 << 31):
        raise OverflowError(f"seed {seed} does not fit in int32")
    return np.array([0, seed & 0xFFFFFFFF], _U32)


def _iota_2x32(shape: Tuple[int, ...]) -> Tuple[np.ndarray, np.ndarray]:
    """A uint64 iota over ``shape`` as (high, low) uint32 words."""
    n = math.prod(shape)
    idx = np.arange(n, dtype=np.uint64).reshape(shape)
    return ((idx >> np.uint64(32)).astype(_U32),
            (idx & np.uint64(0xFFFFFFFF)).astype(_U32))


def split(key: np.ndarray, num: Union[int, Sequence[int]] = 2
          ) -> np.ndarray:
    """``(*shape, 2)`` new keys (the partitionable, fold-like split)."""
    shape = (num,) if isinstance(num, int) else tuple(num)
    hi, lo = _iota_2x32(shape)
    b0, b1 = threefry2x32(key, hi, lo)
    return np.stack([b0, b1], axis=-1)


def fold_in(key, data):
    """Key mixed with a 32-bit integer (negative values wrap).

    ``data`` may be an integer array and ``key`` a stack ``(..., 2)``:
    they broadcast, and the result is ``(*broadcast shape, 2)``, each
    entry ``jax.random.fold_in`` of its key and integer.  A key stack
    that is a tensor (int32 words holding the uint32 bits) gives one on
    its device, of the same bits."""
    if torch.is_tensor(key):
        d = torch.as_tensor(data if torch.is_tensor(data)
                            else np.asarray(data, np.int64),
                            device=key.device)
        d = (d.long() & _M32).to(torch.int32)       # the low word's bits
        b0, b1 = _threefry_torch((key[..., 0], key[..., 1]),
                                 torch.zeros_like(d), d)
        return torch.stack([b0, b1], -1)
    d = (np.asarray(data, np.int64) & 0xFFFFFFFF).astype(_U32)
    # threefry_2x32(key, seed(data)): the count [0, d] is split in halves
    b0, b1 = threefry2x32(key, np.zeros_like(d), d)
    return np.stack([b0, b1], axis=-1)


def random_bits(key: np.ndarray, shape: Tuple[int, ...]) -> np.ndarray:
    """32 random bits per element of ``shape``."""
    hi, lo = _iota_2x32(tuple(shape))
    b0, b1 = threefry2x32(key, hi, lo)
    return b0 ^ b1


def uniform(key: np.ndarray, shape: Tuple[int, ...] = (),
            minval: float = 0.0, maxval: float = 1.0) -> np.ndarray:
    """float32 draws in ``[minval, maxval)``, as ``jax.random.uniform``."""
    shape = tuple(shape)
    bits = random_bits(key, shape)
    one = np.array(1.0, np.float32).view(_U32)
    floats = ((bits >> _U32(32 - 23)) | one).view(np.float32) \
        - np.float32(1.0)
    lo, hi = np.float32(minval), np.float32(maxval)
    # XLA contracts the affine map into one fused multiply-add
    return np.maximum(lo, _fma_f32(floats, hi - lo, lo)).reshape(shape)


def randint(key: np.ndarray, shape: Tuple[int, ...], minval: int,
            maxval: int) -> np.ndarray:
    """int32 draws in ``[minval, maxval)``, as ``jax.random.randint``:
    two words of 32 bits an element, from the two halves of a ``split``,
    folded into the span by uint32 arithmetic (which wraps as XLA's
    does: ``(2**16 % span)**2`` is 0 for spans of 2**16 and more)."""
    shape = tuple(shape)
    lo_i, hi_i = int(minval), int(maxval)
    k1, k2 = split(key)
    higher, lower = random_bits(k1, shape), random_bits(k2, shape)
    span = _U32((hi_i - lo_i) & _M32 if hi_i > lo_i else 1)
    with np.errstate(over="ignore"):
        mult = _U32(1 << 16) % span
        mult = (mult * mult) % span
        off = ((higher % span) * mult + lower % span) % span
    return (np.int64(lo_i) + off.astype(np.int64)).astype(np.int32)


def permutation(key: np.ndarray, n: int) -> np.ndarray:
    """``jax.random.permutation(key, n)``: ``arange(n)`` (int32) sorted
    stably on 32 fresh random bits an element, in ``ceil(3·ln n /
    ln(2**32 - 1))`` rounds (one for any n > 1, none for n = 1), each
    round's bits from the second key of a ``split``."""
    x = np.arange(int(n), dtype=np.int32)
    rounds = int(np.ceil(3 * np.log(max(1, int(n)))
                         / np.log(np.iinfo(np.uint32).max)))
    for _ in range(rounds):
        key, sub = split(key)
        x = x[np.argsort(random_bits(sub, x.shape), kind="stable")]
    return x


def choice(key: np.ndarray, n: int, shape: Tuple[int, ...] = (),
           replace: bool = False) -> np.ndarray:
    """``jax.random.choice(key, n, shape, replace=False)`` (no ``p``): the
    first ``prod(shape)`` entries of ``permutation(key, n)``."""
    if replace:
        raise NotImplementedError("choice draws without replacement only")
    shape = tuple(shape)
    k = math.prod(shape)
    if k > n:
        raise ValueError(f"cannot take {k} of {n} without replacement")
    return permutation(key, n)[:k].reshape(shape)


def _fma_f32(a: np.ndarray, b: np.float32, c: np.float32) -> np.ndarray:
    """float32 ``a*b + c`` rounded once, as a fused multiply-add."""
    p = a.astype(np.float64) * np.float64(b)       # exact: 24 x 24 bits
    s = p + np.float64(c)
    bp = s - p                                     # TwoSum: s + e == p + c
    e = (p - (s - bp)) + (np.float64(c) - bp)
    r = s.astype(np.float32)
    d = s - r.astype(np.float64)
    # s rounded to a float32 tie: the residual e decides the side
    up = np.nextafter(r, np.where(d > 0, np.float32(np.inf),
                                  np.float32(-np.inf)))
    tie = (d != 0) & (np.abs(d) == np.abs(up.astype(np.float64) - s)) \
        & (e != 0) & (np.sign(e) == np.sign(d))
    return np.where(tie, up, r).astype(np.float32)


# ---------------------------------------------------------------------------
# bulk draws in torch: normal and truncated_normal
# ---------------------------------------------------------------------------
_M32 = 0xFFFFFFFF
# XLA's float32 log1p below sqrt(2) - 1 (Cephes), highest degree first
_LOG1P_SMALL = 0.41421356237309504880
_LOG1P_NUM = (4.5270000862445199635215E-5, 4.9854102823193375972212E-1,
              6.5787325942061044846969E0, 2.9911919328553073277375E1,
              6.0949667980987787057556E1, 5.7112963590585538103336E1,
              2.0039553499201281259648E1)
_LOG1P_DEN = (1., 1.5062909083469192043167E1, 8.3047565967967209469434E1,
              2.2176239823732856465394E2, 3.0909872225312059774938E2,
              2.1642788614495947685003E2, 6.0118660497603843919306E1)
# XLA's float32 log on the CPU (Cephes logf), highest degree first
_SQRTHF = 0.707106781186547524
_LOG_P = (7.0376836292E-2, -1.1514610310E-1, 1.1676998740E-1,
          -1.2420140846E-1, 1.4249322787E-1, -1.6668057665E-1,
          2.0000714765E-1, -2.4999993993E-1, 3.3333331174E-1)
_LOG_Q1, _LOG_Q2 = -2.12194440e-4, 0.693359375
# XLA's ErfInv32 (Giles, "Approximating the erfinv function"), highest
# degree first, for w < 5 and for w >= 5
_ERFINV_SMALL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                 -4.39150654e-06, 0.00021858087, -0.00125372503,
                 -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_BIG = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def _i32(v: int) -> int:
    """A 32-bit word (any Python int) as the int32 holding its bits."""
    v &= _M32
    return v - (1 << 32) if v >> 31 else v


def _threefry_torch(key, x0: torch.Tensor, x1: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``threefry2x32`` on int32 tensors holding the uint32 words' bits:
    adds wrap as uint32 adds do, and a logical right shift is an
    arithmetic one masked (half the bytes of int64 words, a third of the
    time on the CPU).  ``key`` is one numpy key, or a pair ``(k0, k1)``
    of int32 tensors that broadcast against the counters."""
    if isinstance(key, np.ndarray):
        k0, k1 = (_i32(int(v)) for v in np.asarray(key, _U32)[:2])
    else:
        k0, k1 = key
    ks = (k0, k1, k0 ^ k1 ^ _i32(int(_PARITY)))
    x0, x1 = torch.broadcast_tensors(x0 + ks[0], x1 + ks[1])
    x0, x1 = x0.contiguous(), x1.contiguous()
    for i in range(5):          # in place: a third of the passes' time
        for r in _ROTATIONS[i % 2]:
            x0.add_(x1)
            hi = (x1 >> (32 - r)) & ((1 << r) - 1)
            x1.bitwise_left_shift_(r).bitwise_or_(hi).bitwise_xor_(x0)
        x0.add_(ks[(i + 1) % 3])
        inc = ks[(i + 2) % 3]
        x1.add_(_i32(inc + i + 1) if isinstance(inc, int) else inc + i + 1)
    return x0, x1


# values a weight draw takes at once: its float64 emulation peaks near
# 145 bytes a value (PERF.md), so about 4.9 GB a slice
DRAW_SLICE = 1 << 25


def _counters(n: int, device, start: int = 0
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The (high, low) words of the uint64 counters ``start`` ..
    ``start + n - 1``, as int32."""
    idx = torch.arange(start, start + n, dtype=torch.int64, device=device)
    return (idx >> 32).to(torch.int32), (idx & _M32).to(torch.int32)


def _uniform_torch(key: np.ndarray, shape: Tuple[int, ...], lo: np.float32,
                   hi: np.float32, device, start: int = 0) -> torch.Tensor:
    """``uniform`` computed on ``device``: float32 ``[lo, hi)``, the
    elements from flat index ``start`` on of a draw that holds them."""
    b0, b1 = _threefry_torch(key, *_counters(math.prod(shape), device,
                                              start))
    bits = (((b0 ^ b1) >> 9) & 0x7FFFFF) | 0x3F800000
    floats = bits.view(torch.float32) - 1.0
    span = torch.full_like(floats, float(np.float32(hi) - np.float32(lo)))
    out = _fma_torch(floats, span, torch.full_like(floats, float(lo)))
    return torch.clamp(out, min=float(lo)).reshape(shape)


# (random bits, mantissa bits, integer type, the bits of 1.0) of a draw,
# as ``jax.random.uniform`` picks them: 8 bits for bfloat16
_UNIFORM_BITS = {torch.float32: (32, 23, torch.int32, 0x3F800000),
                 torch.bfloat16: (8, 7, torch.int16, 0x3F80)}


def uniform_stack(keys: np.ndarray, shape: Tuple[int, ...],
                  dtype=torch.float32, device="cpu") -> torch.Tensor:
    """``(N, *shape)`` draws in ``[0, 1)``: row ``i`` is bitwise
    ``jax.random.uniform(keys[i], shape, dtype)``, float32 or bfloat16.
    The ``(N, 2)`` numpy keys go to ``device`` without a host
    synchronisation (pinned, non-blocking to a card), and the draws are
    made there in one pass over every row; keys that are already a
    tensor (int32 words) are drawn on its device, with no copy."""
    if dtype not in _UNIFORM_BITS:
        raise ValueError(f"uniform_stack draws float32 or bfloat16, not "
                         f"{dtype}")
    if torch.is_tensor(keys):
        keys = keys.reshape(-1, 2)
    else:
        keys = torch.from_numpy(np.ascontiguousarray(keys, _U32)
                                .view(np.int32))
        device = torch.device(device)
        keys = (keys.pin_memory().to(device, non_blocking=True)
                if device.type == "cuda" else keys).reshape(-1, 2)
    b0, b1 = _threefry_torch((keys[:, :1], keys[:, 1:]),
                             *_counters(math.prod(shape), keys.device))
    nbits, nmant, itype, one = _UNIFORM_BITS[dtype]
    bits = b0 ^ b1
    if nbits < 32:                       # the low bits, as JAX narrows them
        bits = bits & ((1 << nbits) - 1)
    mant = (bits >> (nbits - nmant)) & ((1 << nmant) - 1)
    floats = (mant | one).to(itype).view(dtype) - 1.0
    return floats.reshape(keys.shape[0], *shape)


def _fma_torch(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor
               ) -> torch.Tensor:
    """float32 ``a*b + c`` rounded once (``_fma_f32`` in torch)."""
    p = a.double() * b.double()
    cd = c.double()
    s = p + cd
    bp = s - p
    e = (p - (s - bp)) + (cd - bp)
    r = s.float()
    d = s - r.double()
    inf = torch.full_like(r, math.inf)
    up = torch.nextafter(r, torch.where(d > 0, inf, -inf))
    tie = (d != 0) & ((up.double() - s).abs() == d.abs()) & (e != 0) \
        & (torch.sign(e) == torch.sign(d))
    return torch.where(tie, up, r)


def _horner(coeffs, x: torch.Tensor) -> torch.Tensor:
    """Polynomial (highest degree first) by fused multiply-adds."""
    p = torch.zeros_like(x)
    for c in coeffs:
        p = _fma_torch(p, x, torch.full_like(x, float(np.float32(c))))
    return p


def _log(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``log`` on the CPU for positive normal ``x``: Cephes'
    ``logf`` polynomial, its multiply-adds fused."""
    full = lambda v: torch.full_like(x, float(np.float32(v)))  # noqa: E731
    m, e = torch.frexp(x)                      # x = m·2**e, m in [0.5, 1)
    lo = m < float(np.float32(_SQRTHF))
    e = torch.where(lo, e - 1, e).float()
    m = torch.where(lo, (m - 1.0) + m, m - 1.0)
    m2 = m * m
    m3 = m2 * m
    p = _LOG_P
    y = _fma_torch(full(p[0]), m, full(p[1]))
    y1 = _fma_torch(full(p[3]), m, full(p[4]))
    y2 = _fma_torch(full(p[6]), m, full(p[7]))
    y = _fma_torch(y, m, full(p[2]))
    y1 = _fma_torch(y1, m, full(p[5]))
    y2 = _fma_torch(y2, m, full(p[8]))
    y = _fma_torch(y, m3, y1)
    y = _fma_torch(y, m3, y2) * m3
    y = _fma_torch(full(_LOG_Q1), e, y)
    out = _fma_torch(-m2, full(0.5), m) + y
    return _fma_torch(full(_LOG_Q2), e, out)


def _log1p(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``log1p`` on the CPU: Cephes' rational form for
    ``|x| < sqrt(2) - 1``, else ``log(1 + x)``."""
    num = _horner(_LOG1P_NUM, x)
    den = _horner(_LOG1P_DEN, x)
    x2 = x * x
    small = (x * x2) * (num / den)
    small = x + _fma_torch(torch.full_like(x, -0.5), x2, small)
    return torch.where(x.abs() < _LOG1P_SMALL, small, _log(1.0 + x))


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``erf_inv``; the Horner steps are fused
    multiply-adds, as XLA compiles them on the CPU."""
    x = x.float()
    w = -_log1p(-(x * x))
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    small = torch.tensor(_ERFINV_SMALL, dtype=torch.float32, device=x.device)
    big = torch.tensor(_ERFINV_BIG, dtype=torch.float32, device=x.device)
    p = torch.where(lt, small[0], big[0])
    for i in range(1, len(_ERFINV_SMALL)):
        p = _fma_torch(p, w, torch.where(lt, small[i], big[i]))
    out = p * x
    return torch.where(x.abs() == 1, x * torch.finfo(torch.float32).max, out)


_SQRT2 = np.float32(np.sqrt(2))


def normal(key: np.ndarray, shape: Tuple[int, ...], device="cpu"
           ) -> torch.Tensor:
    """float32 standard normals, as ``jax.random.normal``."""
    lo = np.nextafter(np.float32(-1), np.float32(0))
    u = _uniform_torch(key, tuple(shape), lo, np.float32(1), device)
    return float(_SQRT2) * erf_inv(u)


def truncated_normal(key: np.ndarray, lower: float, upper: float,
                     shape: Tuple[int, ...], device="cpu", start: int = 0
                     ) -> torch.Tensor:
    """float32 normals truncated to ``(lower, upper)``, as
    ``jax.random.truncated_normal``.  With ``start``, elements ``start``
    .. ``start + prod(shape) - 1`` of a flat draw that holds them, bit
    for bit (the draw's counter is the flat index)."""
    lower, upper = np.float32(lower), np.float32(upper)
    # erf of a float32, rounded once: XLA's float32 erf gives the same
    # values at the bounds the repo uses (tests/test_torch_random.py)
    a = np.float32(math.erf(float(lower / _SQRT2)))
    b = np.float32(math.erf(float(upper / _SQRT2)))
    u = _uniform_torch(key, tuple(shape), a, b, device, start)
    out = float(_SQRT2) * erf_inv(u)
    return torch.clamp(out, float(np.nextafter(lower, np.float32(np.inf))),
                       float(np.nextafter(upper, np.float32(-np.inf))))


_TINY = np.finfo(np.float32).tiny


def gumbel(key: np.ndarray, shape: Tuple[int, ...], device="cpu"
           ) -> torch.Tensor:
    """float32 Gumbel draws, as ``jax.random.gumbel`` in jax 0.9's
    default ``mode="low"``: ``-log(-log(u))`` for ``u`` uniform in
    ``[tiny, 1)``, both logs XLA's float32 CPU ``log``."""
    u = _uniform_torch(key, tuple(shape), np.float32(_TINY), np.float32(1),
                       device)
    return -_log(-_log(u))


def categorical(key: np.ndarray, logits: torch.Tensor) -> torch.Tensor:
    """One draw a row of ``softmax(logits)`` over the last axis, as
    ``jax.random.categorical(key, logits)``: the Gumbel-max trick, the
    first index of the largest ``gumbel + logits``, drawn on the
    logits' device.  ``logits`` are float32 (JAX draws the noise in
    their dtype).  Returns int64 indices of shape ``logits.shape[:-1]``."""
    if logits.dtype != torch.float32:
        raise TypeError(f"categorical takes float32 logits, not "
                        f"{logits.dtype}")
    g = gumbel(key, tuple(logits.shape), logits.device)
    return torch.argmax(g + logits, dim=-1)
