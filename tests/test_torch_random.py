"""The port's threefry keys and draws against ``jax.random``: bitwise.

``jax.random`` runs with the default threefry implementation and
``jax_threefry_partitionable=True`` (the jax default); every key and
every float32 draw must be bit-for-bit equal.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.quantum import qnn as jqnn
from repro_torch import random as jr
from repro_torch.quantum import qnn as tqnn

SEEDS = [0, 1, 5, 42, 997, 2**31 - 1, -1, -7]


@pytest.mark.parametrize("seed", SEEDS)
def test_prngkey_bitwise(seed):
    np.testing.assert_array_equal(jr.PRNGKey(seed),
                                  np.asarray(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("num", [2, 3, 8, (2, 3)])
def test_split_bitwise(seed, num):
    got = jr.split(jr.PRNGKey(seed), num)
    want = np.asarray(jax.random.split(jax.random.PRNGKey(seed), num))
    assert got.dtype == np.uint32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", SEEDS)
def test_fold_in_bitwise(seed):
    # the reserved client/slot ids of the key contract included
    for data in [0, 1, 7, 12345678, 0x7FFFFFFD, 0x7FFFFFFE, 0x7FFFFFFF]:
        got = jr.fold_in(jr.PRNGKey(seed), data)
        want = np.asarray(jax.random.fold_in(jax.random.PRNGKey(seed), data))
        np.testing.assert_array_equal(got, want)
    # chained, as eval_key folds round, client and slot
    k, kj = jr.PRNGKey(seed), jax.random.PRNGKey(seed)
    for data in (3, 0x7FFFFFFF, 41):
        k, kj = jr.fold_in(k, data), jax.random.fold_in(kj, data)
    np.testing.assert_array_equal(k, np.asarray(kj))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape,lo,hi", [
    ((16,), -math.pi, math.pi), ((40,), -math.pi, math.pi),
    ((3, 5), 0.0, 1.0), ((), 0.0, 1.0), ((1001,), -2.0, 3.0)])
def test_uniform_bitwise(seed, shape, lo, hi):
    key = jr.split(jr.PRNGKey(seed))[1]
    kj = jax.random.split(jax.random.PRNGKey(seed))[1]
    got = jr.uniform(key, shape, lo, hi)
    want = np.asarray(jax.random.uniform(kj, shape, jnp.float32, lo, hi))
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("seed", [0, 2, 5])
@pytest.mark.parametrize("kind,n_qubits", [("vqc", 4), ("vqc", 10),
                                           ("qcnn", 4)])
def test_init_params_draw_bitwise(seed, kind, n_qubits):
    """The orchestrator's initial θ: uniform(split(PRNGKey(seed))[1])."""
    got = tqnn.QNNSpec(kind, n_qubits=n_qubits).init_params(
        jr.split(jr.PRNGKey(seed))[1]).numpy()
    want = np.asarray(jqnn.QNNSpec(kind, n_qubits=n_qubits).init_params(
        jax.random.split(jax.random.PRNGKey(seed))[1]))
    np.testing.assert_array_equal(got, want)
