"""The port's eager statevector simulator and circuits against the JAX
package's, on identical numpy inputs.

``quantum/statevector.py`` and ``quantum/circuits.py`` are the
sequential engine's forward: a batch of rows, the trainable θ shared.
Statevectors, class probabilities and losses agree with the JAX
package's (whose per-example circuit is ``vmap``ped over rows) within
1e-6; the eager forward also agrees with the port's compiled tape.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.quantum import backends as jax_backends
from repro.quantum import circuits as jax_circuits
from repro.quantum import qnn as jax_qnn
from repro.quantum import statevector as jax_sv
from repro_torch.quantum import backends, circuits, qnn, statevector as sv
from repro_torch.quantum import tape

torch.set_num_threads(1)

TOL = 1e-6
SPECS = [("vqc", 4, 2), ("vqc", 3, 2), ("qcnn", 4, 2), ("qcnn", 4, 3),
         ("qcnn", 5, 2)]


def _inputs(kind, n, n_cls, seed=0, rows=7):
    rng = np.random.default_rng(seed)
    spec = qnn.QNNSpec(kind, n_qubits=n, n_classes=n_cls)
    theta = rng.uniform(-np.pi, np.pi, spec.n_params).astype(np.float32)
    X = rng.uniform(0, np.pi, (rows, n)).astype(np.float32)
    y = rng.integers(0, n_cls, rows).astype(np.int32)
    return spec, jax_qnn.QNNSpec(kind, n_qubits=n, n_classes=n_cls), \
        theta, X, y


def _jax_states(fn, X):
    return np.asarray(jax.vmap(fn)(jnp.asarray(X)))


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5])
def test_zz_feature_map_matches_jax(n):
    X = np.random.default_rng(n).uniform(0, np.pi, (6, n)).astype(np.float32)
    got = circuits.zz_feature_map(torch.from_numpy(X)).numpy()
    want = _jax_states(jax_circuits.zz_feature_map, X)
    assert got.shape == (6,) + (2,) * n and got.dtype == np.complex64
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


@pytest.mark.parametrize("n,entangle", [(3, "full"), (4, "full"),
                                        (4, "linear")])
def test_real_amplitudes_matches_jax(n, entangle):
    rng = np.random.default_rng(n)
    X = rng.uniform(0, np.pi, (5, n)).astype(np.float32)
    theta = rng.uniform(-np.pi, np.pi, 4 * n).astype(np.float32)
    got = circuits.real_amplitudes(circuits.zz_feature_map(
        torch.from_numpy(X)), torch.from_numpy(theta), entangle=entangle)
    want = _jax_states(lambda x: jax_circuits.real_amplitudes(
        jax_circuits.zz_feature_map(x), jnp.asarray(theta),
        entangle=entangle), X)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)


@pytest.mark.parametrize("n", [2, 4, 5])
def test_qcnn_matches_jax(n):
    rng = np.random.default_rng(n)
    X = rng.uniform(0, np.pi, (5, n)).astype(np.float32)
    theta = rng.uniform(-np.pi, np.pi,
                        circuits.qcnn_n_params(n)).astype(np.float32)
    psi, q = circuits.qcnn(circuits.zz_feature_map(torch.from_numpy(X)),
                           torch.from_numpy(theta))
    jpsi, jq = jax_circuits.qcnn(jax_circuits.zz_feature_map(
        jnp.asarray(X[0])), jnp.asarray(theta))
    assert q == jq
    want = _jax_states(lambda x: jax_circuits.qcnn(
        jax_circuits.zz_feature_map(x), jnp.asarray(theta))[0], X)
    np.testing.assert_allclose(psi.numpy(), want, atol=TOL, rtol=0)


def test_gates_and_readouts_match_jax():
    """Every gate of the simulator (shared angles, and per-row ones for a
    one-qubit gate), and the probability, ⟨Z⟩, norm and last-qubit
    readouts."""
    rng = np.random.default_rng(3)
    n, B = 3, 4
    X = rng.uniform(0, np.pi, (B, n)).astype(np.float32)
    th = np.float32(0.7)
    rows = rng.uniform(-np.pi, np.pi, B).astype(np.float32)
    psi0 = circuits.zz_feature_map(torch.from_numpy(X))
    jpsi0 = [jax_circuits.zz_feature_map(jnp.asarray(x)) for x in X]
    ops = [(lambda p: sv.h(p, 1), lambda p: jax_sv.h(p, 1)),
           (lambda p: sv.x(p, 2), lambda p: jax_sv.x(p, 2)),
           (lambda p: sv.rx(p, th, 0), lambda p: jax_sv.rx(p, th, 0)),
           (lambda p: sv.ry(p, th, 2), lambda p: jax_sv.ry(p, th, 2)),
           (lambda p: sv.rz(p, th, 1), lambda p: jax_sv.rz(p, th, 1)),
           (lambda p: sv.cx(p, 2, 0), lambda p: jax_sv.cx(p, 2, 0)),
           (lambda p: sv.cz(p, 0, 1), lambda p: jax_sv.cz(p, 0, 1)),
           (lambda p: sv.crz(p, th, 1, 2), lambda p: jax_sv.crz(p, th, 1, 2))]
    for op, jop in ops:
        got = op(psi0).numpy()
        for b in range(B):
            np.testing.assert_allclose(got[b], np.asarray(jop(jpsi0[b])),
                                       atol=TOL, rtol=0)
    got = sv.rz(psi0, torch.from_numpy(rows), 1).numpy()   # one angle a row
    for b in range(B):
        np.testing.assert_allclose(
            got[b], np.asarray(jax_sv.rz(jpsi0[b], rows[b], 1)), atol=TOL,
            rtol=0)
    for q in range(n):
        np.testing.assert_allclose(
            sv.expect_z(psi0, q).numpy(),
            [float(jax_sv.expect_z(p, q)) for p in jpsi0], atol=TOL)
        np.testing.assert_allclose(
            qnn.last_qubit_interpret(psi0, q).numpy(),
            np.stack([np.asarray(jax_qnn.last_qubit_interpret(p, q))
                      for p in jpsi0]), atol=TOL)
    np.testing.assert_allclose(
        sv.probabilities(psi0).numpy(),
        np.stack([np.asarray(jax_sv.probabilities(p)) for p in jpsi0]),
        atol=TOL)
    np.testing.assert_allclose(sv.norm(psi0).numpy(), 1.0, atol=TOL)
    z = sv.zero_state(n, 2)
    assert z.shape == (2, 2, 2, 2) and float(z.abs().sum()) == 2.0


@pytest.mark.parametrize("kind,n,n_cls", SPECS)
def test_forward_matches_jax_and_tape(kind, n, n_cls):
    spec, jspec, theta, X, _ = _inputs(kind, n, n_cls)
    got = qnn.make_forward(spec, "cpu")(theta, X)
    want = np.asarray(jax_qnn.make_forward(jspec)(jnp.asarray(theta),
                                                  jnp.asarray(X)))
    assert got.shape == (X.shape[0], n_cls) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)
    taped = tape.make_tape_forward(spec, "cpu")(torch.from_numpy(theta),
                                                torch.from_numpy(X))
    np.testing.assert_allclose(got.numpy(), taped.numpy(), atol=TOL, rtol=0)


@pytest.mark.parametrize("backend", ["exact", None, "fake-channel"])
@pytest.mark.parametrize("kind,n,n_cls", [("vqc", 4, 2), ("qcnn", 4, 3)])
def test_loss_fn_matches_jax(kind, n, n_cls, backend):
    spec, jspec, theta, X, y = _inputs(kind, n, n_cls, seed=1, rows=9)
    if backend == "fake-channel":        # the fake channel, shots off
        import dataclasses
        tb = dataclasses.replace(backends.get("fake"), shots=0)
        jb = dataclasses.replace(jax_backends.get("fake"), shots=0)
    elif backend is None:
        tb = jb = None
    else:
        tb, jb = backends.get(backend), jax_backends.get(backend)
    got = qnn.make_loss_fn(spec, torch.from_numpy(X), torch.from_numpy(y),
                           backend=tb)(torch.from_numpy(theta))
    want = jax_qnn.make_loss_fn(jspec, jnp.asarray(X), jnp.asarray(y),
                                backend=jb)(jnp.asarray(theta))
    assert got.dim() == 0
    assert abs(float(got) - float(want)) <= TOL




def test_parameter_counts_have_one_copy():
    assert qnn.real_amplitudes_n_params is circuits.real_amplitudes_n_params
    assert qnn.qcnn_n_params is circuits.qcnn_n_params
    for n in range(1, 9):
        assert circuits.qcnn_n_params(n) == jax_circuits.qcnn_n_params(n)
        assert circuits.real_amplitudes_n_params(n) == \
            jax_circuits.real_amplitudes_n_params(n)
