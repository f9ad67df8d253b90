"""CUDA kernel: a whole gate tape replayed on a batch of statevectors in
one launch, each row's state held in shared memory.

The tape-fused redesign of the port of the JAX package's Pallas kernel
``repro/kernels/statevector_gates.py::statevector_gate`` and of the scan
that calls it once a gate (``repro/quantum/tape.py::run_tape``).  The
source, its design and its bound are in ``csrc/statevector_tape.cu``;
the plain version it is held to is ``ref.statevector_tape``, with the
same signature.  This wrapper takes CUDA tensors only and launches the
kernel or raises: it never falls back to the plain version.

Size rule: a row's statevector must fit in shared memory, so the kernel
takes ``n_qubits <= MAX_QUBITS`` (14).  Above it
``repro_torch.quantum.tape.run_tape`` replays the tape with the
per-gate kernel ``statevector_gate`` instead.
"""
from __future__ import annotations

import ctypes
import functools
import weakref

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import GATE_X

NAME = "statevector_tape"
SOURCE = "src/repro_torch/kernels/csrc/statevector_tape.cu"
REPLACES = "src/repro/kernels/statevector_gates.py:61"

# the largest n whose row fits in shared memory: csrc/statevector_tape.cu's
# kMaxQubits, checked against the library when it is loaded
MAX_QUBITS = 14

_P = ctypes.c_void_p


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """Build (first call only) and load the kernel; declare its C
    signature once and hold its size limit to ``MAX_QUBITS``."""
    lib = build.load(NAME)
    fn = lib.svt_statevector_tape
    fn.argtypes = [_P] * 6 + [ctypes.c_longlong, ctypes.c_int,
                              ctypes.c_int, _P]
    fn.restype = ctypes.c_int
    lib.svt_max_qubits.restype = ctypes.c_int
    lib.svt_rows.argtypes = [ctypes.c_int]
    lib.svt_rows.restype = ctypes.c_int
    lib.svt_error_string.argtypes = [ctypes.c_int]
    lib.svt_error_string.restype = ctypes.c_char_p
    if lib.svt_max_qubits() != MAX_QUBITS:
        raise RuntimeError(f"{SOURCE} takes up to {lib.svt_max_qubits()} "
                           f"qubits, {__name__} expects {MAX_QUBITS}")
    return lib


def rows_per_block(n_qubits: int) -> int:
    """Rows of the batch one CTA of the kernel holds at ``n_qubits``."""
    rows = _library().svt_rows(int(n_qubits))
    if rows < 1:
        raise ValueError(f"n_qubits={n_qubits} is outside [1, {MAX_QUBITS}]")
    return rows


def _check_columns(gate_id, target, control, n_qubits):
    """Gate ids in {H, P, RY, RZ, X}, targets in [0, n), controls in
    [-1, n) and unlike their target.  The columns are read to the host
    once and the target column is stamped, so that replays of a tape whose
    columns are cached on the card copy nothing back."""
    stamp = (n_qubits, gate_id._version, target._version, control._version)
    seen = getattr(target, "_tape_checked", None)
    if (seen is not None and seen[0] == stamp and seen[1]() is gate_id
            and seen[2]() is control):
        return
    for g, (gid, tq, cq) in enumerate(zip(gate_id.tolist(), target.tolist(),
                                          control.tolist())):
        if not (0 <= gid <= GATE_X and 0 <= tq < n_qubits
                and -1 <= cq < n_qubits and cq != tq):
            raise ValueError(f"bad gate {g}: gate_id={gid} target={tq} "
                             f"control={cq} n_qubits={n_qubits}")
    target._tape_checked = (stamp, weakref.ref(gate_id), weakref.ref(control))


def _check(angles, gate_id, target, control, n_qubits):
    if not 1 <= n_qubits <= MAX_QUBITS:
        raise ValueError(f"n_qubits={n_qubits} is outside [1, {MAX_QUBITS}]:"
                         " a row's state must fit in shared memory (above it "
                         "run_tape replays the tape with statevector_gate)")
    G = angles.shape[1] if angles.dim() == 2 else -1
    for name, t, dtype, dims in (("angles", angles, torch.float32, 2),
                                 ("gate_id", gate_id, torch.int32, 1),
                                 ("target", target, torch.int32, 1),
                                 ("control", control, torch.int32, 1)):
        if not t.is_cuda or t.device != angles.device:
            raise ValueError(f"{name} must lie on {angles.device} (CUDA)")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.dim() != dims or (dims == 1 and t.shape[0] != G):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{'(B, G)' if dims == 2 else (G,)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    _check_columns(gate_id, target, control, n_qubits)


def statevector_tape(angles: torch.Tensor, gate_id: torch.Tensor,
                     target: torch.Tensor, control: torch.Tensor,
                     n_qubits: int):
    """``(re, im)`` planes ``(B, 2**n)`` after the G gates of the tape on
    |0…0⟩: angles ``(B, G)`` float32, columns ``(G,)`` int32."""
    n_qubits = int(n_qubits)
    _check(angles, gate_id, target, control, n_qubits)
    lib = _library()
    if angles.device.index != torch.cuda.current_device():
        raise ValueError(f"tensors lie on {angles.device}, but the current "
                         f"device is {torch.cuda.current_device()}")
    B, G = angles.shape
    out_re = torch.empty((B, 1 << n_qubits), device=angles.device)
    out_im = torch.empty_like(out_re)
    if B == 0:
        return out_re, out_im
    stream = torch.cuda.current_stream(angles.device).cuda_stream
    err = lib.svt_statevector_tape(
        angles.data_ptr(), gate_id.data_ptr(), target.data_ptr(),
        control.data_ptr(), out_re.data_ptr(), out_im.data_ptr(), B, G,
        n_qubits, stream)
    if err:
        raise RuntimeError(f"{NAME} launch failed: "
                           f"{lib.svt_error_string(err).decode()}")
    statevector_tape.launches += 1
    return out_re, out_im


statevector_tape.launches = 0
