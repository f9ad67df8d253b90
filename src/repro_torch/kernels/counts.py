"""What each hand-written kernel moves and computes, and the workspace
each wrapper allocates, as functions of the launch's shape.

The operation and byte counts are those ``chip_smoke.py`` prices each
kernel's bound with: ``lora_flops_bytes``, ``attn_flops_bytes`` (with
``attn_pairs``, the attendable pairs of one head) and
``int4_flops_bytes``.  The workspace planners are Python copies of the
libraries' own, with the card's SM count an argument (132 on an H100
SXM5): ``lm_workspace`` of ``csrc/lora_matmul.cu`` (``plan`` and
``split_steps`` of ``csrc/tf32x3.cuh``), ``i4_workspace`` of
``csrc/int4_matmul.cu`` and ``fa_backward_workspace`` of
``csrc/flash_attention.cu``; ``chip_smoke.py`` holds each copy to the
library on the card.

A kernel's wrapper given an abstract tensor (a ``FakeTensor``,
``is_abstract``) launches nothing: it allocates what it
would allocate (outputs and workspaces) and adds the launch's counts to
every open ``tally``.  A ctypes launch is invisible to torch's own FLOP
counter, so the dry run reads the kernels' work from here.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List

from torch._subclasses.fake_tensor import FakeTensor

H100_SMS = 132          # H100 SXM5
BM = BN = 128           # csrc/tf32x3.cuh: the projection kernels' tiles
BK = 32
MAX_SPLITS = 8
FA_TILE = 64            # csrc/flash_attention.cu: keys a backward tile


def is_abstract(t) -> bool:
    """A tensor with a shape and no data under ``FakeTensorMode`` (a
    DTensor by its local shard), whatever device it names."""
    return isinstance(getattr(t, "_local_tensor", t), FakeTensor)


# ---------------------------------------------------------------------------
# operations and bytes
# ---------------------------------------------------------------------------
def lora_flops_bytes(C, M, K, N, r, elem=4):
    flops = 2 * C * M * (K * N + K * r + r * N)
    nbytes = elem * (C * M * K + K * N + C * K * r + C * r * N + C * M * N)
    return flops, nbytes


def attn_pairs(S: int, causal: bool = True, window: int = 0,
               Sk: int = None) -> int:
    """Attendable (query, key) pairs of one head: what the data needs
    (``Sk`` keys, ``S`` by default, for non-causal attention); query row
    ``i`` of a causal head sees ``min(i + 1, window)`` keys."""
    if not causal and not window:
        return S * (Sk or S)
    if not causal:
        return S * S
    if not window or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


def attn_flops_bytes(B, S, H, KH, D, backward=False, elem=4, Dv=None,
                     Sk=None, causal=True, window=0):
    """Operations and bytes of attention of ``S`` query rows over ``Sk``
    keys (``S`` by default; causal unless stated): the forward reads q, k
    and v and writes o (of v's head dim ``Dv``) and the row logsumexp;
    the backward reads q, k, v, o, dO and the logsumexp and writes dq, dk
    and dv."""
    Dv, Sk = Dv or D, Sk or S
    pairs = B * H * attn_pairs(S, causal, window, Sk=Sk)
    if not backward:     # S = QK^T (D) and PV (Dv), 2 flops a product
        return (2 * (D + Dv) * pairs,
                elem * (B * S * H * (D + Dv) + B * Sk * KH * (D + Dv))
                + 4 * B * H * S)
    # S and dK, dQ (D); dP and dV (Dv): 2 flops a product
    return ((6 * D + 4 * Dv) * pairs,
            elem * (B * S * H * 2 * (D + Dv) + B * Sk * KH * 2 * (D + Dv))
            + 4 * B * H * S)


def int4_flops_bytes(M, K, N, qblock=64):
    """NN and NT alike: 2MKN flops; x (or dy) and the output in float32,
    the packed weight at half a byte and its scales."""
    return 2 * M * K * N, 4 * M * K + K * N // 2 + 4 * K * N // qblock \
        + 4 * M * N


# ---------------------------------------------------------------------------
# workspace planners (Python copies of the libraries')
# ---------------------------------------------------------------------------
def split_steps(ctas: int, steps: int, sms: int) -> int:
    """Reduction steps a split takes (``csrc/tf32x3.cuh``): a grid under
    three quarters of a wave splits its reduction, at most
    ``MAX_SPLITS`` ways and at least 4 steps a split."""
    if ctas <= 0 or steps <= 0 or 4 * ctas >= 3 * sms:
        return steps if steps > 0 else 1
    s = min(sms // ctas, steps // 4, MAX_SPLITS)
    if s < 2:
        return steps
    return (steps + s - 1) // s


def _splits(ctas: int, K: int, sms: int) -> int:
    nk = (K + BK - 1) // BK
    per = split_steps(ctas, nk, sms)
    return (nk + per - 1) // per if nk > 0 else 1


def _tiles(M: int, N: int) -> int:
    return ((N + BN - 1) // BN) * ((M + BM - 1) // BM)


def lm_splits(C: int, M: int, N: int, K: int, sms: int = H100_SMS) -> int:
    """The ways ``lora_matmul`` splits its reduction at this launch."""
    return _splits(_tiles(M, N) * C, K, sms)


def lm_workspace(C: int, M: int, N: int, K: int, r: int,
                 sms: int = H100_SMS) -> int:
    """Floats of workspace ``lora_matmul`` needs at this launch (0: none)."""
    splits = lm_splits(C, M, N, K, sms)
    if splits < 2 or r < 1 or r > 32:
        return 0
    rank_pad = 8 if r <= 8 else 16 if r <= 16 else 32
    return splits * C * M * (N + rank_pad)


def i4_workspace(M: int, Kw: int, Nw: int, trans: bool,
                 sms: int = H100_SMS) -> int:
    """Floats of workspace ``int4_matmul`` needs at this launch (0: none):
    NN reduces over ``Kw`` into ``Nw`` columns, NT the reverse."""
    R, O = (Nw, Kw) if trans else (Kw, Nw)
    splits = _splits(_tiles(M, O), R, sms)
    return splits * M * O if splits > 1 else 0


def fa_backward_workspace(B: int, S: int, Sk: int, H: int, D: int) -> int:
    """Bytes of float32 workspace the attention backward needs: none up
    to one tile of keys, else rowsum(dO O) ``(B, H, S)`` padded to 16
    bytes and one dQ slab ``(B, S, H, D)`` a key tile."""
    nkt = (Sk + FA_TILE - 1) // FA_TILE
    if nkt <= 1:
        return 0
    delta = (B * S * H + 3) // 4 * 4
    return 4 * (delta + nkt * B * S * H * D)


# ---------------------------------------------------------------------------
# the tally of abstract launches
# ---------------------------------------------------------------------------
class Tally:
    """Per kernel: abstract launches, operations and bytes."""

    def __init__(self):
        self.kernels: Dict[str, Dict[str, float]] = {}

    def add(self, name: str, flops: float, nbytes: float):
        k = self.kernels.setdefault(name, dict(calls=0, flops=0, bytes=0))
        k["calls"] += 1
        k["flops"] += flops
        k["bytes"] += nbytes

    @property
    def flops(self) -> float:
        return sum(k["flops"] for k in self.kernels.values())

    @property
    def bytes(self) -> float:
        return sum(k["bytes"] for k in self.kernels.values())


_OPEN: List[Tally] = []


@contextlib.contextmanager
def tally():
    """A ``Tally`` of the abstract launches made inside the block."""
    t = Tally()
    _OPEN.append(t)
    try:
        yield t
    finally:
        _OPEN.remove(t)


def add(name: str, flops: float, nbytes: float):
    """Count one abstract launch in every open tally."""
    for t in _OPEN:
        t.add(name, flops, nbytes)
