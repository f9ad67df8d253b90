"""The tape kernel's plain version and dispatch on the CPU.

``ref.statevector_tape`` (``gate_planes``, then one ``statevector_gate`` a
gate) is the contract the CUDA kernel ``statevector_tape`` is held to on
the card (``test_torch_cuda_tape.py``, ``chip_smoke.py``).  Here it is
held to the JAX package's ``run_tape`` scan, with its jnp gate apply and
with the Pallas kernel in interpret mode, on compiled tapes and on every
prefix length tried, from the same numpy angles.  Tolerance 1e-6 (max
abs), the tape tolerance of ``test_torch_tape.py``: the same float32
formulas, but torch's and XLA's sin/cos and complex products may round
differently in the last ulp (about 2e-7 on amplitudes in [-1, 1]).
"""
import dataclasses
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.quantum import qnn as jax_qnn
from repro.quantum import tape as jax_tape
from repro_torch.kernels import ops, ref
from repro_torch.kernels import statevector_gates as svg
from repro_torch.kernels import statevector_tape as svt
from repro_torch.quantum import qnn, tape

# small shapes: one intra-op thread per test worker, or the workers
# oversubscribe the cores
torch.set_num_threads(1)

TOL = 1e-6
COLUMNS = ("gate_id", "target", "control")


def _compiled(kind, n):
    return (tape.compile_qnn(qnn.QNNSpec(kind, n_qubits=n)),
            jax_tape.compile_qnn(jax_qnn.QNNSpec(kind, n_qubits=n)))


def _angles(jcq, B, seed):
    """JAX's per-gate angles of random features and parameters, (B, G)."""
    rng = np.random.default_rng(seed)
    n = jcq.n_qubits
    n_params = jax_qnn.QNNSpec(jcq.kind, n_qubits=n).n_params
    X = rng.uniform(0, np.pi, (B, n)).astype(np.float32)
    theta = rng.uniform(-np.pi, np.pi, n_params).astype(np.float32)
    return np.array(jax_tape.tape_angles(jcq.tape, jnp.asarray(X),
                                         jnp.asarray(theta)))


def _columns(gate_tape, g=None):
    return [torch.from_numpy(getattr(gate_tape, c)[:g]) for c in COLUMNS]


def _assert_matches(re, im, psi):
    psi = np.asarray(psi)
    np.testing.assert_allclose(re.numpy(), psi.real, atol=TOL, rtol=0)
    np.testing.assert_allclose(im.numpy(), psi.imag, atol=TOL, rtol=0)


@pytest.mark.parametrize("gate_apply", ["jnp", "pallas"])
@pytest.mark.parametrize("kind,n", [(k, n) for k in ("vqc", "qcnn")
                                    for n in (2, 3, 4, 6)])
def test_statevector_tape_plain_matches_jax(kind, n, gate_apply):
    cq, jcq = _compiled(kind, n)
    ang = _angles(jcq, 6, seed=n)
    re, im = ref.statevector_tape(torch.from_numpy(ang),
                                  *_columns(cq.tape), n)
    apply = jax_tape.pallas_gate_apply if gate_apply == "pallas" else None
    _assert_matches(re, im, jax_tape.run_tape(jcq.tape, jnp.asarray(ang),
                                              gate_apply=apply))


@pytest.mark.parametrize("kind,n,g", [("vqc", 4, g) for g in
                                      (0, 1, 2, 9, 31, 60, 85, 86)]
                         + [("qcnn", 6, g) for g in (3, 40, 77, 111)])
def test_tape_prefix_matches_jax_scan(kind, n, g):
    """The first g gates against the JAX scan over the same prefix, so
    the chain is held gate by gate."""
    cq, jcq = _compiled(kind, n)
    assert g <= cq.tape.n_gates
    ang = _angles(jcq, 5, seed=g)[:, :g]
    prefix = dataclasses.replace(jcq.tape, **{
        f.name: getattr(jcq.tape, f.name)[:g]
        for f in dataclasses.fields(jcq.tape)
        if isinstance(getattr(jcq.tape, f.name), np.ndarray)})
    re, im = ref.statevector_tape(torch.from_numpy(np.ascontiguousarray(ang)),
                                  *_columns(cq.tape, g), n)
    _assert_matches(re, im, jax_tape.run_tape(prefix, jnp.asarray(ang)))


def test_run_tape_on_cpu_is_the_plain_gate_chain_bitwise():
    """On the CPU ``run_tape`` computes what it computed before the tape
    kernel: ``gate_planes`` and one plain ``statevector_gate`` a gate."""
    cq, jcq = _compiled("vqc", 4)
    ang = torch.from_numpy(_angles(jcq, 7, seed=3))
    g_re, g_im = tape.gate_planes(cq.tape, ang)
    want_re = torch.zeros(7, 16)
    want_re[:, 0] = 1.0
    want_im = torch.zeros_like(want_re)
    for gi, (t, c) in enumerate(zip(cq.tape.target.tolist(),
                                    cq.tape.control.tolist())):
        want_re, want_im = ref.statevector_gate(want_re, want_im, g_re[gi],
                                                g_im[gi], t, c, 4)
    re, im = tape.run_tape(cq.tape, ang)
    assert torch.equal(re, want_re) and torch.equal(im, want_im)


def test_ops_statevector_tape_on_cpu_is_plain_and_launches_nothing():
    cq, jcq = _compiled("qcnn", 4)
    ang = torch.from_numpy(_angles(jcq, 4, seed=5))
    before = (svt.statevector_tape.launches, svg.statevector_gate.launches)
    got = ops.statevector_tape(ang, *_columns(cq.tape), 4)
    want = ref.statevector_tape(ang, *_columns(cq.tape), 4)
    assert (svt.statevector_tape.launches,
            svg.statevector_gate.launches) == before
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_ops_statevector_tape_rejects_other_devices():
    ang = torch.zeros(2, 3, device="meta")
    cols = [torch.zeros(3, dtype=torch.int32, device="meta")] * 3
    with pytest.raises(ValueError, match="no statevector_tape for device"):
        ops.statevector_tape(ang, *cols, 2)


def test_the_wrapper_takes_cuda_tensors_only():
    """The kernel's wrapper never runs the plain version: CPU tensors
    handed to it directly are refused before anything is built."""
    cq, jcq = _compiled("vqc", 2)
    ang = torch.from_numpy(_angles(jcq, 2, seed=0))
    with pytest.raises(ValueError, match="CUDA"):
        svt.statevector_tape(ang, *_columns(cq.tape), 2)


def test_size_rule_threshold():
    """The largest n whose row fits in a Hopper block's 227 KB of shared
    memory is 14 (8 bytes an amplitude: 128 KB a row; n = 15 would take
    256 KB).  The wrapper's limit is the one the kernel's source states."""
    assert svt.MAX_QUBITS == 14
    row_bytes = lambda n: 8 << n  # noqa: E731
    assert row_bytes(svt.MAX_QUBITS) <= 227 * 1024 < row_bytes(
        svt.MAX_QUBITS + 1)
    source = (pathlib.Path(__file__).resolve().parents[1]
              / svt.SOURCE).read_text()
    limit = re.search(r"constexpr int kMaxQubits = (\d+);", source)
    assert limit and int(limit.group(1)) == svt.MAX_QUBITS


@pytest.mark.parametrize("n", [svt.MAX_QUBITS, svt.MAX_QUBITS + 1])
def test_run_tape_size_rule(monkeypatch, n):
    """Up to MAX_QUBITS ``run_tape`` is one ``ops.statevector_tape``;
    above it one ``ops.statevector_gate`` a gate, with the same result."""
    tb = tape.TapeBuilder(n)
    tb.h(0)
    tb.ry_theta(n - 1, 0)
    tb.cx(0, n - 1)
    tb.rz_theta(1, 1)
    tb.cx(n - 1, 1)
    tb.p_linear(n - 2, 0)
    gate_tape = tb.build()
    calls = {"tape": 0, "gate": 0}

    def spy(name, fn):
        def counted(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return counted

    monkeypatch.setattr(ops, "statevector_tape",
                        spy("tape", ops.statevector_tape))
    monkeypatch.setattr(ops, "statevector_gate",
                        spy("gate", ops.statevector_gate))
    ang = torch.from_numpy(np.random.default_rng(n).uniform(
        -3, 3, (2, gate_tape.n_gates)).astype(np.float32))
    replays = tape.run_tape.replays
    re, im = tape.run_tape(gate_tape, ang)
    assert tape.run_tape.replays == replays + 1
    if n <= svt.MAX_QUBITS:
        assert calls == {"tape": 1, "gate": 0}
    else:
        assert calls == {"tape": 0, "gate": gate_tape.n_gates}
    want = ref.statevector_tape(ang, *_columns(gate_tape), n)
    assert torch.equal(re, want[0]) and torch.equal(im, want[1])
    norm = (re * re + im * im).sum(-1)
    assert float((norm - 1).abs().max()) <= 1e-6


def test_column_check_rejects_bad_gates_and_rechecks_after_a_write():
    gid = torch.tensor([0, 4, 2], dtype=torch.int32)
    target = torch.tensor([0, 1, 2], dtype=torch.int32)
    control = torch.tensor([-1, 0, -1], dtype=torch.int32)
    svt._check_columns(gid, target, control, 3)
    svt._check_columns(gid, target, control, 3)          # stamped: no copy
    with pytest.raises(ValueError, match="bad gate 2"):
        svt._check_columns(gid, target, control, 2)      # target 2 >= n
    control[2] = 2                                       # control == target
    with pytest.raises(ValueError, match="bad gate 2"):
        svt._check_columns(gid, target, control, 3)
    control[2] = 1
    gid[0] = 5                                           # no such gate
    with pytest.raises(ValueError, match="bad gate 0"):
        svt._check_columns(gid, target, control, 3)
