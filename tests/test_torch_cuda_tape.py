"""The hand-written ``statevector_tape`` kernel on the card: against its
plain version ``ref.statevector_tape`` and against the chain of per-gate
kernel launches it replaces.  This file imports no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_tape.py

Without a card every case skips: the kernel has no CPU mode.  Tolerance
1e-6 max abs up to 4 qubits, 1e-5 above (hundreds of gates at n = 10):
the kernel repeats the plain version's float32 products and sums one by
one and PyTorch's sinf/cosf, so it is meant to agree bit for bit; the
share of bitwise-equal amplitudes is printed.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref
from repro_torch.kernels import statevector_gates as svg
from repro_torch.kernels import statevector_tape as svt
from repro_torch.quantum import qnn, tape

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


def random_tape(n, rng):
    """One gate of a random kind for every (target, control) pair."""
    pairs = [(t, c) for t in range(n) for c in [-1] + [c for c in range(n)
                                                      if c != t]]
    gid = rng.integers(0, 5, len(pairs)).astype(np.int32)
    target = np.array([t for t, _ in pairs], np.int32)
    control = np.array([c for _, c in pairs], np.int32)
    return gid, target, control


def tapes(n, rng):
    cq = tape.compile_qnn(qnn.QNNSpec("vqc", n_qubits=n))
    yield "vqc", (cq.tape.gate_id, cq.tape.target, cq.tape.control)
    yield "random", random_tape(n, rng)


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 6, 7, 8, 10, 12, 14])
def test_statevector_tape_matches_plain_and_gate_chain(cuda, n):
    rng = np.random.default_rng(n)
    tol = 1e-6 if n <= 4 else 1e-5
    for name, cols in tapes(n, rng):
        G = len(cols[0])
        cols = [torch.from_numpy(c).to(cuda) for c in cols]
        for B in (1, 7, 300):
            ang = torch.from_numpy(rng.uniform(-2 * np.pi, 2 * np.pi, (B, G))
                                   .astype(np.float32)).to(cuda)
            before = svt.statevector_tape.launches
            got = svt.statevector_tape(ang, *cols, n)
            assert svt.statevector_tape.launches == before + 1
            want = ref.statevector_tape(ang, *cols, n)
            chain = ref.statevector_tape(ang, *cols, n,
                                         gate=svg.statevector_gate)
            equal = sum(int((g == c).sum()) for g, c in zip(got, chain))
            err = max(float((g - w).abs().max()) for g, w in zip(got, want))
            print(f"n={n} {name} B={B} G={G}: max abs err {err:.3g}, "
                  f"bitwise equal to the gate chain on "
                  f"{equal / (2 * B << n):.6f}")
            assert err <= tol
            norm = (got[0] ** 2 + got[1] ** 2).sum(-1)
            assert float((norm - 1).abs().max()) <= 1e-5


def test_run_tape_is_one_launch_a_replay(cuda):
    cq = tape.compile_qnn(qnn.QNNSpec("vqc", n_qubits=4))
    X = torch.rand(5, 4, device=cuda) * np.pi
    theta = torch.rand(16, device=cuda) * 6 - 3
    ang = tape.tape_angles(cq.tape, X, theta)
    counts = lambda: (svt.statevector_tape.launches,  # noqa: E731
                      svg.statevector_gate.launches, tape.run_tape.replays)
    before = counts()
    for _ in range(3):
        tape.run_tape(cq.tape, ang)
    assert counts() == (before[0] + 3, before[1], before[2] + 3)


def test_run_tape_above_the_limit_launches_the_gate_kernel(cuda):
    n = svt.MAX_QUBITS + 1
    tb = tape.TapeBuilder(n)
    for q in range(n):
        tb.h(q)
    tb.cx(0, n - 1)
    tb.ry_theta(n - 1, 0)
    gate_tape = tb.build()
    ang = torch.rand(3, gate_tape.n_gates, device=cuda) * 6 - 3
    before = (svt.statevector_tape.launches, svg.statevector_gate.launches)
    re, im = tape.run_tape(gate_tape, ang)
    assert (svt.statevector_tape.launches,
            svg.statevector_gate.launches) == (before[0],
                                               before[1] + gate_tape.n_gates)
    want = ref.statevector_tape(ang, *[torch.from_numpy(getattr(
        gate_tape, c)).to(cuda) for c in ("gate_id", "target", "control")], n)
    assert float((re - want[0]).abs().max()) <= 1e-6
    assert float((im - want[1]).abs().max()) <= 1e-6


def test_rows_per_block(cuda):
    """Lanes of one 128-thread CTA own a row up to 6 qubits, a CTA owns
    one row above; n outside [1, MAX_QUBITS] is refused."""
    for n in range(1, svt.MAX_QUBITS + 1):
        assert svt.rows_per_block(n) == (128 >> (n - 1) if n <= 6 else 1)
    for n in (0, svt.MAX_QUBITS + 1):
        with pytest.raises(ValueError, match="outside"):
            svt.rows_per_block(n)


def test_statevector_tape_rejects_bad_inputs(cuda):
    i32 = dict(dtype=torch.int32, device=cuda)
    ang = torch.zeros(3, 2, device=cuda)
    gid = torch.tensor([0, 4], **i32)
    target = torch.tensor([0, 1], **i32)
    control = torch.tensor([-1, 0], **i32)
    svt.statevector_tape(ang, gid, target, control, 2)           # valid
    with pytest.raises(ValueError, match="bad gate 1"):           # c == t
        svt.statevector_tape(ang, gid, target,
                             torch.tensor([-1, 1], **i32), 2)
    with pytest.raises(ValueError, match="shape"):               # G differs
        svt.statevector_tape(torch.zeros(3, 3, device=cuda), gid, target,
                             control, 2)
    with pytest.raises(ValueError, match="contiguous"):
        svt.statevector_tape(torch.zeros(2, 3, device=cuda).t(), gid,
                             target, control, 2)
    with pytest.raises(TypeError, match="int32"):
        svt.statevector_tape(ang, gid.long(), target, control, 2)
    with pytest.raises(ValueError, match="outside"):             # n > limit
        svt.statevector_tape(ang, gid, target, control, svt.MAX_QUBITS + 1)
    with pytest.raises(ValueError, match="CUDA"):
        svt.statevector_tape(ang, gid.cpu(), target, control, 2)
    with pytest.raises(ValueError, match="no statevector_tape"):
        ops.statevector_tape(torch.zeros(3, 2, device="meta"), gid, target,
                             control, 2)
