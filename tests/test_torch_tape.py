"""The port's tape compiler, executor, QNN heads and backends against
the JAX package on identical numpy inputs.

Tape arrays are compared exactly.  Angles, statevectors and class
probabilities agree within 1e-6 (max abs): the same float32 formulas,
but torch's and XLA's sin/cos/exp and complex products may round
differently in the last ulp.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.quantum import backends as jax_backends
from repro.quantum import qnn as jax_qnn
from repro.quantum import tape as jax_tape
from repro_torch.quantum import backends, qnn, tape

# small shapes: one intra-op thread per test worker, or the workers
# oversubscribe the cores
torch.set_num_threads(1)

TOL = 1e-6
SPECS = [("vqc", 4, 2), ("vqc", 6, 2), ("qcnn", 4, 2), ("qcnn", 4, 3),
         ("qcnn", 7, 2)]


def _specs(kind, n, n_classes):
    return (qnn.QNNSpec(kind, n_qubits=n, n_classes=n_classes),
            jax_qnn.QNNSpec(kind, n_qubits=n, n_classes=n_classes))


def _data(spec, B, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.uniform(0, np.pi, (B, spec.n_qubits)).astype(np.float32)
    theta = rng.uniform(-np.pi, np.pi, spec.n_params).astype(np.float32)
    return X, theta


@pytest.mark.parametrize("kind,n,n_classes", SPECS)
def test_compile_qnn_tapes_equal(kind, n, n_classes):
    ts, js = _specs(kind, n, n_classes)
    assert ts.n_params == js.n_params
    got, want = tape.compile_qnn(ts), jax_tape.compile_qnn(js)
    assert (got.kind, got.n_qubits, got.n_classes, got.readout) == \
        (want.kind, want.n_qubits, want.n_classes, want.readout)
    for f in dataclasses.fields(want.tape):
        a, b = getattr(got.tape, f.name), getattr(want.tape, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b


def test_quickstart_and_wide_tape_sizes():
    """The sizes the chip run relies on: 86 gates / 16 params at 4
    qubits, 485 gates / 40 params at 10 qubits."""
    for n, gates, params in ((4, 86, 16), (10, 485, 40)):
        spec = qnn.QNNSpec("vqc", n_qubits=n)
        assert tape.compile_qnn(spec).tape.n_gates == gates
        assert spec.n_params == params


@pytest.mark.parametrize("kind,n,n_classes", SPECS)
def test_tape_angles_match(kind, n, n_classes):
    ts, js = _specs(kind, n, n_classes)
    X, theta = _data(ts, 9)
    got = tape.tape_angles(tape.compile_qnn(ts).tape, torch.from_numpy(X),
                           torch.from_numpy(theta))
    want = jax_tape.tape_angles(jax_tape.compile_qnn(js).tape,
                                jnp.asarray(X), jnp.asarray(theta))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=0)


@pytest.mark.parametrize("kind,n,n_classes", SPECS)
def test_run_tape_matches(kind, n, n_classes):
    ts, js = _specs(kind, n, n_classes)
    X, theta = _data(ts, 11, seed=1)
    cq, jcq = tape.compile_qnn(ts), jax_tape.compile_qnn(js)
    ang = jax_tape.tape_angles(jcq.tape, jnp.asarray(X), jnp.asarray(theta))
    re, im = tape.run_tape(cq.tape, torch.from_numpy(np.array(ang)))
    for gate_apply in (None, jax_tape.pallas_gate_apply):
        psi = np.asarray(jax_tape.run_tape(jcq.tape, ang,
                                           gate_apply=gate_apply))
        np.testing.assert_allclose(re.numpy(), psi.real, atol=TOL, rtol=0)
        np.testing.assert_allclose(im.numpy(), psi.imag, atol=TOL, rtol=0)


@pytest.mark.parametrize("kind,n,n_classes", SPECS)
def test_tape_probs_match(kind, n, n_classes):
    ts, js = _specs(kind, n, n_classes)
    X, theta = _data(ts, 13, seed=2)
    got = tape.make_tape_forward(ts, "cpu")(torch.from_numpy(theta),
                                            torch.from_numpy(X))
    want = jax_tape.make_tape_forward(js)(jnp.asarray(theta),
                                          jnp.asarray(X))
    assert got.shape == (13, n_classes)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=0)


def test_tape_probs_batches_candidates_per_client():
    """(C, K, P) candidates on (C, B, n) shards in one replay equal the
    candidates one by one — the batch dimension the engine relies on."""
    ts, _ = _specs("vqc", 4, 2)
    cq = tape.compile_qnn(ts)
    rng = np.random.default_rng(3)
    X = torch.from_numpy(rng.uniform(0, np.pi, (3, 5, 4)).astype(np.float32))
    th = torch.from_numpy(rng.uniform(-3, 3, (3, 2, 16)).astype(np.float32))
    got = tape.tape_probs(cq, th, X[:, None])
    assert got.shape == (3, 2, 5, 2)
    for c in range(3):
        for k in range(2):
            want = tape.tape_probs(cq, th[c, k], X[c])
            np.testing.assert_allclose(got[c, k].numpy(), want.numpy(),
                                       atol=TOL, rtol=0)


@pytest.mark.parametrize("n,n_classes", [(4, 2), (4, 3), (6, 2)])
def test_parity_nll_accuracy_match(n, n_classes):
    rng = np.random.default_rng(n + n_classes)
    probs = rng.dirichlet(np.ones(1 << n), 17).astype(np.float32)
    got = qnn.parity_interpret(torch.from_numpy(probs), n, n_classes)
    want = jax_qnn.parity_interpret(jnp.asarray(probs), n, n_classes)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=0)
    y = rng.integers(0, n_classes, 17).astype(np.int32)
    cls = np.asarray(want)
    np.testing.assert_allclose(
        float(qnn.nll_loss(torch.tensor(cls), torch.tensor(y))),
        float(jax_qnn.nll_loss(jnp.asarray(cls), jnp.asarray(y))),
        atol=TOL, rtol=0)
    assert float(qnn.accuracy(torch.tensor(cls), torch.tensor(y))) \
        == float(jax_qnn.accuracy(jnp.asarray(cls), jnp.asarray(y)))


@pytest.mark.parametrize("name", ["exact", "fake", "aersim", "real"])
def test_backends_match(name):
    tb, jb = backends.get(name), jax_backends.get(name)
    assert dataclasses.asdict(tb) == dataclasses.asdict(jb)
    rng = np.random.default_rng(0)
    for C in (2, 3):
        probs = rng.dirichlet(np.ones(C), 8).astype(np.float32)
        np.testing.assert_allclose(
            tb.apply_channel(torch.from_numpy(probs)).numpy(),
            np.asarray(jb.apply_channel(jnp.asarray(probs))), atol=TOL,
            rtol=0)
    for n in (1, 50, 400):
        assert tb.eval_time(n) == jb.eval_time(n)
    if tb.shots:        # a finite-shot backend needs a key, as in JAX
        with pytest.raises(ValueError, match="shots"):
            tb.transform_probs(torch.from_numpy(probs))
        with pytest.raises(ValueError, match="shots"):
            jb.transform_probs(jnp.asarray(probs))


def test_reserved_ids_match():
    for name in ("FINAL_EVAL_SLOT", "REPORT_EVAL_SLOT", "DROPOUT_EVAL_SLOT",
                 "SERVER_CLIENT", "POP_CLIENT", "POP_SLOT_COHORT",
                 "SERVER_SLOT_LOSS_PRE", "SERVER_SLOT_LOSS_POST",
                 "SERVER_SLOT_VAL_ACC", "SERVER_SLOT_TEST_ACC"):
        assert getattr(backends, name) == getattr(jax_backends, name)
