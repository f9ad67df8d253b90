"""The port's threefry keys and draws against ``jax.random``: bitwise.

``jax.random`` runs with the default threefry implementation and
``jax_threefry_partitionable=True`` (the jax default); every key and
every uniform float32 draw must be bit-for-bit equal.  ``normal`` and
``truncated_normal`` go through a port of XLA's float32 ``erf_inv``:
within 2 ulp of ``jax.random`` on every value, and bitwise on at least
99.9 % of them.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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


# --- normal / truncated_normal: XLA's erf_inv, to 2 ulp ----------------------
def _ulps(got: np.ndarray, want: np.ndarray) -> np.ndarray:
    return np.abs(got.view(np.int32).astype(np.int64)
                  - want.view(np.int32).astype(np.int64))


@pytest.mark.parametrize("seed", [0, 3, 11, -7])
@pytest.mark.parametrize("shape", [(1000,), (128, 4), (37, 5), (4, 3, 2)])
def test_normal_within_2ulp(seed, shape):
    key = jr.split(jr.PRNGKey(seed))[1]
    kj = jax.random.split(jax.random.PRNGKey(seed))[1]
    got = jr.normal(key, shape).numpy()
    want = np.asarray(jax.random.normal(kj, shape, jnp.float32))
    assert got.dtype == np.float32 and got.shape == want.shape
    assert _ulps(got, want).max() <= 2


@pytest.mark.parametrize("seed", [0, 3, 11, -7])
@pytest.mark.parametrize("shape", [(1000,), (128, 4), (37, 5)])
def test_truncated_normal_within_2ulp(seed, shape):
    key = jr.split(jr.PRNGKey(seed))[1]
    kj = jax.random.split(jax.random.PRNGKey(seed))[1]
    got = jr.truncated_normal(key, -2.0, 2.0, shape).numpy()
    want = np.asarray(jax.random.truncated_normal(kj, -2.0, 2.0, shape,
                                                  jnp.float32))
    assert _ulps(got, want).max() <= 2
    assert got.min() > -2.0 and got.max() < 2.0


@pytest.mark.parametrize("draw", ["normal", "truncated_normal"])
def test_bulk_draws_mostly_bitwise(draw):
    """Over 200,000 values at least 99.9 % are bitwise equal (the erf_inv
    port reproduces XLA's log1p and log up to rare roundings)."""
    key, kj = jr.PRNGKey(5), jax.random.PRNGKey(5)
    if draw == "normal":
        got = jr.normal(key, (200_000,)).numpy()
        want = np.asarray(jax.random.normal(kj, (200_000,), jnp.float32))
    else:
        got = jr.truncated_normal(key, -2.0, 2.0, (200_000,)).numpy()
        want = np.asarray(jax.random.truncated_normal(
            kj, -2.0, 2.0, (200_000,), jnp.float32))
    ulps = _ulps(got, want)
    assert ulps.max() <= 2
    assert np.mean(ulps == 0) >= 0.999


def test_erf_inv_matches_xla():
    u = np.concatenate([np.random.default_rng(0).uniform(-1, 1, 50_000),
                        [0.0, 0.5, -0.5, 0.999, -0.9999999]]
                       ).astype(np.float32)
    got = jr.erf_inv(torch.from_numpy(u)).numpy()
    want = np.asarray(jax.lax.erf_inv(jnp.asarray(u)))
    assert _ulps(got, want).max() <= 2


def test_truncation_bounds_are_xla_erf():
    """The uniform's bounds erf(±2/√2), rounded once, are XLA's values."""
    s2 = np.float32(np.sqrt(2))
    for lo in (-2.0, 2.0):
        v = np.float32(lo) / s2
        assert np.float32(math.erf(float(v))) == np.asarray(
            jax.lax.erf(jnp.float32(v)))


# --- permutation and choice(replace=False): the fused loop's cohorts ---------
@pytest.mark.parametrize("seed", [0, 4, 997, -7])
def test_permutation_and_choice_bitwise(seed):
    """Every n in 1..64 under several keys: ``jax.random.permutation`` and
    ``jax.random.choice(..., replace=False)``, bit for bit."""
    base = jr.PRNGKey(seed)
    for n in range(1, 65):
        for slot in (0, 0x7FFFFFFD):
            key = jr.fold_in(jr.fold_in(base, n), slot)
            kj = jnp.asarray(key)
            got = jr.permutation(key, n)
            np.testing.assert_array_equal(
                got, np.asarray(jax.random.permutation(kj, n)))
            assert got.dtype == np.int32
            k = max(1, (n * 3) // 7)
            np.testing.assert_array_equal(
                jr.choice(key, n, (k,)),
                np.asarray(jax.random.choice(kj, n, (k,), replace=False)))


def test_choice_rejects_what_it_does_not_draw():
    with pytest.raises(ValueError, match="without replacement"):
        jr.choice(jr.PRNGKey(0), 3, (4,))
    with pytest.raises(NotImplementedError):
        jr.choice(jr.PRNGKey(0), 3, (2,), replace=True)


def test_device_key_stacks_draw_the_same_bits():
    """A key stack staged as a tensor of int32 words: ``fold_in`` and
    ``uniform_stack`` give the bits of the numpy path."""
    ck = jr.fold_in(jr.PRNGKey(3), np.arange(5))
    slots = np.array([0, 17, 0x7FFFFFFE, 0x7FFFFFFF, -3])
    want = jr.fold_in(ck[:, None, :], slots)
    got = jr.fold_in(torch.from_numpy(ck[:, None, :].view(np.int32)), slots)
    assert got.dtype == torch.int32 and got.shape == (5, 5, 2)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    np.testing.assert_array_equal(
        jr.uniform_stack(got, (7, 11)).numpy(),
        jr.uniform_stack(want.reshape(-1, 2), (7, 11)).numpy().reshape(
            5, 5, 7, 11).reshape(25, 7, 11))
