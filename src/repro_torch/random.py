"""Threefry-2x32 keys: ``PRNGKey``, ``split``, ``fold_in``, ``uniform``.

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
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import numpy as np

_U32 = np.uint32
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = _U32(0x1BD11BDA)


def _rotl(v: np.ndarray, r: int) -> np.ndarray:
    return (v << _U32(r)) | (v >> _U32(32 - r))


def threefry2x32(key: np.ndarray, x0: np.ndarray, x1: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """The Threefry-2x32 block cipher (20 rounds) on counter pairs."""
    k0, k1 = np.asarray(key, _U32)[:2]
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


def fold_in(key: np.ndarray, data: int) -> np.ndarray:
    """Key mixed with a 32-bit integer (negative values wrap)."""
    d = int(data) & 0xFFFFFFFF
    # threefry_2x32(key, seed(data)): the count [0, d] is split in halves
    b0, b1 = threefry2x32(key, np.array([0], _U32), np.array([d], _U32))
    return np.array([b0[0], b1[0]], _U32)


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
