"""Finite-shot sampling in the port against the JAX package: bitwise.

``backends.sample_counts`` and ``Backend.transform_probs`` on the same
seeded numpy probabilities and the same keys as the JAX package's, over
B ∈ {1, 50, 4750}, C ∈ {2, 3}, shots ∈ {1, 100, 1000}, float32 and
bfloat16, with NaN, zero-mass and negative rows: every count and every
frequency bit for bit (a NaN as NaN).  Then the key chain
(``eval_key``, the vectorised ``fold_in``, ``uniform_stack`` one key a
row), the keyed loss and the keyed client objective, against the JAX
package's.
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import distill as jdistill
from repro.quantum import backends as jb
from repro.quantum import qnn as jqnn
from repro_torch import random as jr
from repro_torch.core import distill
from repro_torch.quantum import backends as tb
from repro_torch.quantum import qnn

torch.set_num_threads(1)

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
NOISY = ("fake", "aersim", "real")      # a case's transform_probs backend
CASES = list(itertools.product((1, 50, 4750), (2, 3), (1, 100, 1000),
                               DTYPES))


def _probs(B, C, seed):
    """Dirichlet rows; from 4 rows on, a NaN, a zero-mass and a negative
    row among them."""
    p = np.random.default_rng(seed).dirichlet(np.ones(C), B)
    p = p.astype(np.float32)
    if B >= 4:
        p[1] = np.nan
        p[2] = 0.0
        p[3] = -0.5
    return p


def _key(B, C, shots):
    return jr.fold_in(jr.fold_in(jr.PRNGKey(B), C), shots)


def _bits(t: torch.Tensor) -> np.ndarray:
    """The values' bits, every NaN as one pattern (a NaN's sign and
    payload are not part of its value)."""
    bits = t.view(torch.int16 if t.dtype == torch.bfloat16
                  else torch.int32).numpy()
    return np.where(torch.isnan(t).numpy(), -1, bits)


def _jbits(a) -> np.ndarray:
    a = np.asarray(a)
    bits = a.view(np.int16 if a.dtype.itemsize == 2 else np.int32)
    return np.where(np.isnan(a.astype(np.float32)), -1, bits)


@pytest.fixture(scope="module")
def jax_refs():
    """Every case's JAX counts and noisy frequencies, once."""
    out = {}
    for i, (B, C, shots, dt) in enumerate(CASES):
        jdt = DTYPES[dt][1]
        p = jnp.asarray(_probs(B, C, i)).astype(jdt)
        key = jnp.asarray(_key(B, C, shots))
        out[i] = (_jbits(jb.sample_counts(key, p, shots)),
                  _jbits(jb.get(NOISY[i % 3]).transform_probs(p, key)))
    return out


@pytest.mark.parametrize("case", range(len(CASES)),
                         ids=["B{}-C{}-s{}-{}".format(*c) for c in CASES])
def test_sample_counts_and_transform_probs_bitwise(jax_refs, case):
    B, C, shots, dt = CASES[case]
    p = torch.from_numpy(_probs(B, C, case)).to(DTYPES[dt][0])
    key = _key(B, C, shots)
    counts = tb.sample_counts(key, p, shots)
    assert counts.dtype == p.dtype and counts.shape == p.shape
    want_counts, want_freq = jax_refs[case]
    np.testing.assert_array_equal(_bits(counts), want_counts)
    np.testing.assert_array_equal(
        _bits(tb.get(NOISY[case % 3]).transform_probs(p, key)), want_freq)
    if B >= 4:
        assert torch.isnan(counts[1]).all()
    if dt == "float32":     # bfloat16 holds integers exactly only to 256
        finite = counts[~torch.isnan(counts).any(-1)]
        assert (finite.sum(-1) == shots).all()


def test_sample_counts_key_stack_is_each_key_alone():
    """A ``(K1, K2, B, C)`` stack under ``(K1, K2, 2)`` keys: each block
    bitwise its own single-key call (the batched engine's draw)."""
    rng = np.random.default_rng(7)
    p = torch.from_numpy(rng.dirichlet(np.ones(2), (3, 4, 50))
                         .astype(np.float32))
    keys = jr.fold_in(jr.fold_in(jr.PRNGKey(1), np.arange(3))[:, None, :],
                      np.array([0, 17, 0x7FFFFFFF, 5]))
    got = tb.sample_counts(keys, p, 100)
    for i in range(3):
        for k in range(4):
            want = jb.sample_counts(jnp.asarray(keys[i, k]),
                                    jnp.asarray(p[i, k].numpy()), 100)
            np.testing.assert_array_equal(got[i, k].numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="key stack"):
        tb.sample_counts(keys[:2], p, 100)


@pytest.mark.parametrize("name", ["fake", "aersim", "real"])
def test_transform_probs_needs_a_key(name):
    p = torch.tensor([[0.9, 0.1]])
    with pytest.raises(ValueError, match="shots"):
        tb.get(name).transform_probs(p)
    with pytest.raises(ValueError, match="shots"):
        jb.get(name).transform_probs(jnp.asarray(p.numpy()))
    torch.testing.assert_close(tb.get("exact").transform_probs(p), p)


def test_eval_key_and_vector_fold_in_bitwise():
    base, jbase = jr.PRNGKey(3), jax.random.PRNGKey(3)
    for r, c, s in itertools.product(
            (1, 7), (0, 2, tb.SERVER_CLIENT),
            (0, 5, tb.REPORT_EVAL_SLOT, tb.FINAL_EVAL_SLOT)):
        np.testing.assert_array_equal(
            tb.eval_key(base, r, c, s), np.asarray(jb.eval_key(jbase, r, c, s)))
    # a (C, 2) client stack against a (K,) slot row: (C, K, 2)
    ck = jr.fold_in(jr.fold_in(base, 2), np.arange(5))
    slots = 17 + 3 * 19 + np.arange(19)
    keys = jr.fold_in(ck[:, None, :], slots)
    assert keys.shape == (5, 19, 2) and keys.dtype == np.uint32
    for c in range(5):
        for k in range(19):
            np.testing.assert_array_equal(
                keys[c, k], np.asarray(jb.eval_key(jbase, 2, c, slots[k])))


@pytest.mark.parametrize("dt", DTYPES)
def test_uniform_stack_bitwise_per_key(dt):
    keys = jr.fold_in(jr.PRNGKey(11), np.arange(12) * 977)
    got = jr.uniform_stack(keys, (100, 50), DTYPES[dt][0])
    assert got.shape == (12, 100, 50)
    for i in range(12):
        want = jax.random.uniform(jnp.asarray(keys[i]), (100, 50),
                                  DTYPES[dt][1])
        np.testing.assert_array_equal(_bits(got[i]), _jbits(want))


def _qnn_inputs(seed=0, B=40):
    rng = np.random.default_rng(seed)
    spec = qnn.QNNSpec("vqc", n_qubits=4)
    X = rng.uniform(-1, 1, (B, 4)).astype(np.float32)
    y = rng.integers(0, 2, B).astype(np.int32)
    theta = rng.uniform(-np.pi, np.pi, spec.n_params).astype(np.float32)
    teacher = rng.dirichlet(np.ones(2), B).astype(np.float32)
    return spec, X, y, theta, teacher


@pytest.mark.parametrize("name", ["fake", "aersim", "real"])
def test_keyed_loss_and_objective_match_jax(name):
    """``make_loss_fn`` is keyed on a finite-shot backend, as JAX's; the
    keyed client objective samples F_i only.  Margins are printed: equal
    sampled losses need every draw farther from a CDF boundary than the
    forwards differ (the eager circuits, ~1e-7)."""
    spec, X, y, theta, teacher = _qnn_inputs()
    jspec = jqnn.QNNSpec("vqc", n_qubits=4)
    tX, ty = torch.from_numpy(X), torch.from_numpy(y)
    loss = qnn.make_loss_fn(spec, tX, ty, backend=tb.get(name))
    jloss = jqnn.make_loss_fn(jspec, jnp.asarray(X), jnp.asarray(y),
                              backend=jb.get(name))
    obj = distill.make_client_objective(
        loss, qnn.make_forward(spec, "cpu"), tX, torch.from_numpy(teacher),
        theta.astype(np.float64) * 0.5, keyed=True)
    jobj = jdistill.make_client_objective(
        jloss, jqnn.make_forward(jspec), jnp.asarray(X),
        jnp.asarray(teacher), theta.astype(np.float64) * 0.5, keyed=True)
    with tb.track_margin() as m:
        for slot in (0, 3, tb.FINAL_EVAL_SLOT):
            key = tb.eval_key(jr.PRNGKey(5), 1, 2, slot)
            jkey = jnp.asarray(key)
            got = float(loss(torch.from_numpy(theta), key))
            assert got == pytest.approx(float(jloss(jnp.asarray(theta), jkey)),
                                        abs=1e-6)
            assert obj(theta, key) == pytest.approx(jobj(theta, jkey),
                                                    abs=1e-6)
    print(f"{name}: smallest draw-to-boundary distance {m.value:.3g} over "
          f"{m.draws} draws, {m.near} within {m.NEAR}")
    assert m.draws == 6 * 40 * 100 and m.value > 0
    assert m.near <= m.chance_bound()
    # a different key draws differently
    a = float(loss(torch.from_numpy(theta), tb.eval_key(jr.PRNGKey(5), 1, 2,
                                                        0)))
    b = float(loss(torch.from_numpy(theta), tb.eval_key(jr.PRNGKey(6), 1, 2,
                                                        0)))
    assert a != b


def test_near_draws_are_compared_draw_for_draw():
    """Two recorded runs near a boundary: a class flip is allowed only
    where the runs' boundaries straddle the draw no more than NEAR
    apart; a larger shift or a draw missing from one run is found."""
    key = jr.PRNGKey(3)
    u0 = float(jr.uniform_stack(np.asarray(key)[None], (100, 1),
                                torch.float32)[0, 0, 0])

    def run(p0):
        probs = torch.tensor([[p0, 1.0 - p0]], dtype=torch.float32)
        with tb.track_margin(record=True) as m:
            tb.sample_counts(key, probs, 100)
        return m

    below = run(u0 - 3e-7)
    assert below.near >= 1 and below.value <= 1e-6
    same = below.near_disagreements(run(u0 - 3e-7))
    assert same == (below.near, 0, 0, 0.0)
    # the draw above the boundary in one run, below it in the other
    flip = below.near_disagreements(run(u0 + 3e-7))
    assert flip.flipped == 1 and flip.unexplained == 0
    assert flip.shift == pytest.approx(6e-7, rel=0.1)
    # boundaries 1.8e-6 apart, and a draw 5e-6 away in the other run
    assert below.near_disagreements(run(u0 + 1.5e-6)).unexplained == 1
    assert below.near_disagreements(run(u0 + 5e-6)).unexplained == 1
    assert below.chance_bound() == pytest.approx(
        2e-6 * 100 + 6 * (2e-6 * 100) ** 0.5 + 6)
