"""Circuit tape compiler and executor on split-plane statevectors.

The port of ``repro/quantum/tape.py``.  The paper's circuits are compiled
**once** (numpy, exactly as in the JAX package) into a flat tape of

  (gate_id, target, control, angle-source)

rows, and replayed on a batch of ``(B, 2**n)`` flat statevectors.  Every
gate reduces to one (optionally controlled) 2×2 unitary:

  H, P(θ), RY(θ), RZ(θ), and CX = controlled-X.

``angle = const + feature_term + theta_pad[theta_idx]`` with
``theta_pad = [0, *theta]`` so index 0 means "no parameter".

Qubit 0 is bit ``n-1-q`` of the flat big-endian index.  The statevector
stays as two float32 planes (re, im) throughout.  ``run_tape`` replays
the whole tape through ``kernels.ops.statevector_tape``: on the card one
launch of the hand-written tape kernel, which builds each gate's matrix
from its angle and keeps every row's state in shared memory; on the CPU
its plain version, which builds all G gates' ``(G, B, 2, 2)`` re/im
planes in one vectorised pass (``gate_planes``, the JAX package's
per-step ``lax.switch`` over gate kinds) and applies them one gate at a
time.  Size rule: above ``statevector_tape.MAX_QUBITS`` (14) qubits a
row's state no longer fits in shared memory, and ``run_tape`` applies
the gate planes with ``kernels.ops.statevector_gate``, one launch a gate.

Batch dimensions are written out: ``tape_probs`` takes ``theta``
``(..., P)`` and ``X`` ``(..., B, n)`` broadcasting against each other,
so one replay evaluates every client's every candidate point.
"""
from __future__ import annotations

import functools
import math
import weakref
from dataclasses import dataclass
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from repro_torch.kernels import ops, ref
from repro_torch.kernels import statevector_tape as svt
from repro_torch.kernels.ref import (  # noqa: F401  (re-export)
    GATE_H, GATE_P, GATE_RY, GATE_RZ, GATE_X, pair_indices)
from repro_torch.quantum import qnn

XMODE_NONE, XMODE_LINEAR, XMODE_ZZ = 0, 1, 2


@dataclass(frozen=True, eq=False)
class GateTape:
    """Flat compiled circuit: parallel arrays, one row per gate.
    Hashed by identity, so its device copies can be cached weakly."""
    n_qubits: int
    gate_id: np.ndarray      # (G,) int32 in {H, P, RY, RZ, X}
    target: np.ndarray       # (G,) int32
    control: np.ndarray      # (G,) int32, -1 = uncontrolled
    const: np.ndarray        # (G,) float32 additive constant angle
    xmode: np.ndarray        # (G,) int32 ∈ {NONE, LINEAR, ZZ}
    xi: np.ndarray           # (G,) int32 feature index i
    xj: np.ndarray           # (G,) int32 feature index j (ZZ only)
    theta_idx: np.ndarray    # (G,) int32 into [0, *theta]; 0 = none

    @property
    def n_gates(self) -> int:
        return int(self.gate_id.shape[0])


class TapeBuilder:
    def __init__(self, n_qubits: int):
        self.n_qubits = n_qubits
        self._rows: List[Tuple] = []

    def _add(self, gid, target, control=-1, const=0.0, xmode=XMODE_NONE,
             xi=0, xj=0, theta=-1):
        self._rows.append((gid, target, control, const, xmode, xi, xj,
                           theta + 1))

    def h(self, q):
        self._add(GATE_H, q)

    def p_linear(self, q, feat):
        """P(2·x[feat]) on qubit q (ZZFeatureMap single-qubit phase)."""
        self._add(GATE_P, q, xmode=XMODE_LINEAR, xi=feat)

    def p_zz(self, q, fi, fj):
        """P(2·(π−x[fi])(π−x[fj])) on qubit q (ZZ entangling phase)."""
        self._add(GATE_P, q, xmode=XMODE_ZZ, xi=fi, xj=fj)

    def ry_theta(self, q, k):
        self._add(GATE_RY, q, theta=k)

    def rz_theta(self, q, k):
        self._add(GATE_RZ, q, theta=k)

    def rz_const(self, q, angle):
        self._add(GATE_RZ, q, const=angle)

    def cx(self, control, target):
        self._add(GATE_X, target, control=control)

    def build(self) -> GateTape:
        cols = list(zip(*self._rows))
        i32 = functools.partial(np.asarray, dtype=np.int32)
        return GateTape(
            n_qubits=self.n_qubits,
            gate_id=i32(cols[0]), target=i32(cols[1]), control=i32(cols[2]),
            const=np.asarray(cols[3], np.float32), xmode=i32(cols[4]),
            xi=i32(cols[5]), xj=i32(cols[6]), theta_idx=i32(cols[7]))


# ---------------------------------------------------------------------------
# compilers — gate for gate the JAX package's (tests/test_torch_tape.py
# holds the tape arrays equal)
# ---------------------------------------------------------------------------
def compile_zz_feature_map(tb: TapeBuilder, *, reps: int = 2) -> None:
    n = tb.n_qubits
    for _ in range(reps):
        for q in range(n):
            tb.h(q)
            tb.p_linear(q, q)
        for i in range(n):
            for j in range(i + 1, n):
                tb.cx(i, j)
                tb.p_zz(j, i, j)
                tb.cx(i, j)


def compile_real_amplitudes(tb: TapeBuilder, *, reps: int = 3,
                            entangle: str = "full") -> None:
    n = tb.n_qubits
    for r in range(reps):
        for q in range(n):
            tb.ry_theta(q, r * n + q)
        if entangle == "full":
            pairs = [(i, j) for i in range(n) for j in range(i + 1, n)]
        else:
            pairs = [(i, i + 1) for i in range(n - 1)]
        for (i, j) in pairs:
            tb.cx(i, j)
    for q in range(n):
        tb.ry_theta(q, reps * n + q)


def _compile_conv2(tb, k, q1, q2):
    tb.rz_const(q2, -np.pi / 2)
    tb.cx(q2, q1)
    tb.rz_theta(q1, k)
    tb.ry_theta(q2, k + 1)
    tb.cx(q1, q2)
    tb.ry_theta(q2, k + 2)
    tb.cx(q2, q1)
    tb.rz_const(q1, np.pi / 2)


def _compile_pool2(tb, k, src, dst):
    tb.rz_const(dst, -np.pi / 2)
    tb.cx(dst, src)
    tb.rz_theta(src, k)
    tb.ry_theta(dst, k + 1)
    tb.cx(src, dst)
    tb.ry_theta(dst, k + 2)


def compile_qcnn(tb: TapeBuilder) -> int:
    """QCNN conv/pool stages; returns the readout qubit index."""
    active = list(range(tb.n_qubits))
    k = 0
    while len(active) > 1:
        pairs = [(active[2 * i], active[2 * i + 1])
                 for i in range(len(active) // 2)]
        for (a, b) in pairs:
            _compile_conv2(tb, k, a, b)
            k += 3
        survivors = []
        for (a, b) in pairs:
            _compile_pool2(tb, k, a, b)
            k += 3
            survivors.append(b)
        if len(active) % 2:
            survivors.append(active[-1])
        active = survivors
    return active[0]


@dataclass(frozen=True)
class CompiledQNN:
    """A QNNSpec lowered to a tape + readout recipe."""
    kind: str
    n_qubits: int
    n_classes: int
    tape: GateTape
    readout: int = -1        # QCNN surviving qubit; -1 = parity interpret


def compile_qnn(spec) -> CompiledQNN:
    """Lower a ``qnn.QNNSpec`` to a ``CompiledQNN``."""
    tb = TapeBuilder(spec.n_qubits)
    compile_zz_feature_map(tb, reps=spec.fm_reps)
    readout = -1
    if spec.kind == "vqc":
        compile_real_amplitudes(tb, reps=spec.ansatz_reps)
    elif spec.kind == "qcnn":
        readout = compile_qcnn(tb)
    else:
        raise ValueError(spec.kind)
    return CompiledQNN(spec.kind, spec.n_qubits, spec.n_classes,
                       tb.build(), readout)


# ---------------------------------------------------------------------------
# execution
# ---------------------------------------------------------------------------
# tape → {device: its columns there}; dropped with the tape
_ON_DEVICE: "weakref.WeakKeyDictionary[GateTape, dict]" = \
    weakref.WeakKeyDictionary()


def _columns(tape: GateTape, device) -> Dict[str, torch.Tensor]:
    """The tape's columns as tensors on ``device``, copied there once."""
    per_device = _ON_DEVICE.setdefault(tape, {})
    if str(device) not in per_device:
        cols = {name: torch.as_tensor(getattr(tape, name)).to(device)
                for name in ("gate_id", "target", "control", "const",
                             "xmode", "xi", "xj", "theta_idx")}
        for name in ("xi", "xj", "theta_idx"):
            cols[name] = cols[name].long()
        per_device[str(device)] = cols
    return per_device[str(device)]


def tape_angles(tape: GateTape, X: torch.Tensor,
                theta: torch.Tensor) -> torch.Tensor:
    """Per-gate angles: X ``(..., B, n)``, theta ``(..., P)`` →
    ``(..., B, G)`` float32 (leading dims broadcast)."""
    c = _columns(tape, X.device)
    xi = X[..., c["xi"]]                                 # (..., B, G)
    xj = X[..., c["xj"]]
    pi = math.pi
    xterm = torch.where(
        c["xmode"] == XMODE_LINEAR, 2.0 * xi,
        torch.where(c["xmode"] == XMODE_ZZ,
                    2.0 * (pi - xi) * (pi - xj), torch.zeros_like(xi)))
    theta = theta.float()
    theta_pad = torch.cat([torch.zeros_like(theta[..., :1]), theta], -1)
    return c["const"] + xterm + theta_pad[..., c["theta_idx"]][..., None, :]


def gate_planes(tape: GateTape, angles: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """All gates' matrices for a batch: angles ``(B, G)`` → re/im planes
    ``(G, B, 2, 2)``, one contiguous ``(B, 2, 2)`` block per gate
    (``kernels.ref.gate_planes`` on the tape's gate ids)."""
    return ref.gate_planes(_columns(tape, angles.device)["gate_id"], angles)


def run_tape(tape: GateTape, angles: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Replay the tape on |0…0⟩ for a batch: angles ``(B, G)`` →
    statevector planes ``(re, im)``, each ``(B, 2**n)`` float32.

    Up to ``svt.MAX_QUBITS`` qubits one ``ops.statevector_tape``; above
    it (the size rule) the gate planes applied by one
    ``ops.statevector_gate`` a gate."""
    c = _columns(tape, angles.device)
    if tape.n_qubits <= svt.MAX_QUBITS:
        out = ops.statevector_tape(angles, c["gate_id"], c["target"],
                                   c["control"], tape.n_qubits)
    else:
        out = ref.statevector_tape(angles, c["gate_id"], tape.target,
                                   tape.control, tape.n_qubits,
                                   gate=ops.statevector_gate)
    run_tape.replays += 1
    return out


run_tape.replays = 0


def tape_probs(cq: CompiledQNN, theta: torch.Tensor,
               X: torch.Tensor) -> torch.Tensor:
    """Class probabilities ``(..., B, n_classes)``: theta ``(..., P)`` and
    X ``(..., B, n)`` broadcast, all rows replayed as one batch."""
    angles = tape_angles(cq.tape, X, theta)              # (..., B, G)
    lead = angles.shape[:-1]
    re, im = run_tape(cq.tape, angles.reshape(-1, angles.shape[-1]))
    probs = re * re + im * im                            # (rows, 2**n)
    if cq.kind == "qcnn" and cq.n_classes == 2:
        q = cq.readout
        out = probs.reshape(-1, 1 << q, 2, probs.shape[-1] >> (q + 1))
        out = out.sum(dim=(1, 3))
    else:
        out = qnn.parity_interpret(probs, cq.n_qubits, cq.n_classes)
    return out.reshape(*lead, out.shape[-1])


def make_tape_forward(spec, device) -> Callable:
    """(theta, X (B, n)) → class probs (B, n_classes) on ``device``,
    backed by the compiled tape."""
    cq = compile_qnn(spec)
    device = torch.device(device)

    def forward(theta, X):
        return tape_probs(cq, torch.as_tensor(theta).to(device),
                          torch.as_tensor(X).to(device))

    return forward
