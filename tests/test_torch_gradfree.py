"""The port's host optimizers (``optim/gradfree.py``) and batched SPSA
(``optim/batched_spsa.py``) against the JAX package's.

``gradfree`` is numpy in float64 in both packages: on the same numpy
objectives, Nelder–Mead traces, simplexes and eval counts and SPSA
states are bitwise equal, and so are the Rademacher streams
(``spsa_rng``, ``make_deltas``).  The batched SPSA is float32 on the
device: within 2e-5 of JAX's with equal ``n_evals`` (the tolerance of
``tests/test_batched_engine.py``), and of the port's own ``spsa_run``.
The port's batched Nelder–Mead matches its ``nm_run`` decision for
decision, as ``tests/test_batched_nm.py`` requires of the JAX package.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import batched_spsa as jax_bspsa
from repro.optim import gradfree as jax_gf
from repro_torch.optim import batched_nm, batched_spsa, gradfree

torch.set_num_threads(1)


def _quad(center):
    c = np.asarray(center, np.float64)
    return lambda x: float(np.sum((np.asarray(x) - c) ** 2))


def _rosen(x):
    x = np.asarray(x)
    return float(np.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2
                        + (1 - x[:-1]) ** 2))


OBJECTIVES = {"quad": _quad(np.linspace(-1, 1, 5)), "rosen": _rosen}


@pytest.mark.parametrize("name", sorted(OBJECTIVES))
@pytest.mark.parametrize("chunks", [(12,), (4, 0, 9)])
def test_nm_run_matches_jax(name, chunks):
    """Resumed in chunks, with the branch trace: bitwise JAX's."""
    fn = OBJECTIVES[name]
    x0 = np.array([0.5, -0.3, 0.0, 1.2, -2.0])
    st, jst = gradfree.nm_init(fn, x0), jax_gf.nm_init(fn, x0)
    trace, jtrace = [], []
    for k in chunks:
        st = gradfree.nm_run(fn, st, k, trace=trace)
        jst = jax_gf.nm_run(fn, jst, k, trace=jtrace)
    assert trace == jtrace and len(trace) == sum(chunks)
    assert (st.n_evals, st.n_iters) == (jst.n_evals, jst.n_iters)
    np.testing.assert_array_equal(st.simplex, jst.simplex)
    np.testing.assert_array_equal(st.fvals, jst.fvals)
    assert st.best_f == jst.best_f


@pytest.mark.parametrize("chunks", [(10,), (3, 7)])
def test_spsa_run_matches_jax(chunks):
    fn = OBJECTIVES["quad"]
    x0 = np.full(5, 0.25)
    st = gradfree.spsa_init(fn, x0, seed=17)
    jst = jax_gf.spsa_init(fn, x0, seed=17)
    for k in chunks:
        st, jst = gradfree.spsa_run(fn, st, k), jax_gf.spsa_run(fn, jst, k)
    np.testing.assert_array_equal(st.x, jst.x)
    assert (st.f, st.k, st.n_evals, st.seed) == \
        (jst.f, jst.k, jst.n_evals, jst.seed)


@pytest.mark.parametrize("method", ["nelder-mead", "spsa"])
def test_optimizer_facade_and_set_fn_match_jax(method):
    fn, fn2 = OBJECTIVES["quad"], OBJECTIVES["rosen"]
    x0 = np.array([0.1, 0.2, 0.3, 0.4, 0.5])
    opt = gradfree.GradFreeOptimizer(fn, x0, method=method, seed=3)
    jopt = jax_gf.GradFreeOptimizer(fn, x0, method=method, seed=3)
    for o in (opt, jopt):
        o.run(4)
        o.set_fn(fn2)
        o.run(3)
    (x, f), (jx, jf) = opt.best, jopt.best
    np.testing.assert_array_equal(x, jx)
    assert f == jf and opt.n_evals == jopt.n_evals
    with pytest.raises(ValueError):
        gradfree.GradFreeOptimizer(fn, x0, method="cobyla")


@pytest.mark.parametrize("seed,k", [(0, 0), (42, 0), (997 * 3 + 2, 5)])
def test_spsa_rng_bitwise(seed, k):
    got = gradfree.spsa_rng(seed, k).choice([-1.0, 1.0], size=64)
    want = jax_gf.spsa_rng(seed, k).choice([-1.0, 1.0], size=64)
    np.testing.assert_array_equal(got, want)


def test_make_deltas_bitwise():
    seeds = [0, 1, 997, 1994]
    got = batched_spsa.make_deltas(seeds, 7, 16)
    np.testing.assert_array_equal(got, jax_bspsa.make_deltas(seeds, 7, 16))
    rng = gradfree.spsa_rng(997, 0)              # a fresh run: k = 0
    np.testing.assert_array_equal(
        got[2], np.stack([rng.choice([-1.0, 1.0], size=16)
                          for _ in range(7)]))


DIM, SEEDS = 6, [101, 202, 303]
CENTERS = np.stack([np.linspace(-1, 1, DIM) * (c + 1)
                    for c in range(3)]).astype(np.float32)


def _tf(xs):                   # (C, K, P) → (C, K)
    return torch.sum((xs - torch.from_numpy(CENTERS)[:, None]) ** 2, -1)


def _jf(xs):                   # (C, P) → (C,)
    return jnp.sum((xs - jnp.asarray(CENTERS)) ** 2, axis=-1)


@pytest.mark.parametrize("iters", [[7, 3, 0], [5, 5, 5], [0, 0, 0]])
def test_batched_spsa_matches_jax(iters):
    deltas = batched_spsa.make_deltas(SEEDS, 8, DIM)
    x0 = np.full((3, DIM), 0.5, np.float32)
    x, f, n = batched_spsa.batched_spsa(_tf, torch.from_numpy(x0), iters,
                                        torch.from_numpy(deltas))
    jx, jfin, jn = jax_bspsa.batched_spsa(_jf, x0, np.asarray(iters),
                                          deltas)
    np.testing.assert_array_equal(n.numpy(), np.asarray(jn))
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), atol=2e-5, rtol=0)
    np.testing.assert_allclose(f.numpy(), np.asarray(jfin), atol=2e-5,
                               rtol=0)
    assert x.dtype == torch.float32
    for c in range(3):
        if iters[c] == 0:              # a zero budget never moves
            np.testing.assert_array_equal(x[c].numpy(), x0[c])


def test_batched_spsa_matches_spsa_run_per_client():
    iters = [7, 3, 0]
    deltas = batched_spsa.make_deltas(SEEDS, 8, DIM)
    x0 = np.full((3, DIM), 0.5)
    x, _, n = batched_spsa.batched_spsa(_tf, torch.from_numpy(x0).float(),
                                        iters, torch.from_numpy(deltas))
    for c in range(3):
        fn = _quad(CENTERS[c].astype(np.float64))
        st = gradfree.spsa_init(fn, x0[c], seed=SEEDS[c])
        st = gradfree.spsa_run(fn, st, iters[c])
        np.testing.assert_allclose(x[c].numpy(), st.x, atol=2e-5)
        assert int(n[c]) == st.n_evals


def test_batched_spsa_active_mask_and_keyed():
    deltas = torch.from_numpy(batched_spsa.make_deltas(SEEDS, 8, DIM))
    x0 = torch.full((3, DIM), 0.5)
    full = batched_spsa.batched_spsa(_tf, x0, [4, 4, 4], deltas)
    part = batched_spsa.batched_spsa(_tf, x0, [4, 4, 4], deltas,
                                     active=[True, False, True])
    jx, _, jn = jax_bspsa.batched_spsa(_jf, x0.numpy(), np.array([4, 4, 4]),
                                       deltas.numpy(),
                                       active=np.array([True, False, True]))
    np.testing.assert_array_equal(part[2].numpy(), np.asarray(jn))
    assert part[2].tolist() == [14, 0, 14]
    np.testing.assert_array_equal(part[0][1].numpy(), x0[1].numpy())
    for c in (0, 2):            # the others advance as if all were active
        np.testing.assert_array_equal(part[0][c].numpy(),
                                      full[0][c].numpy())
    np.testing.assert_allclose(part[0].numpy(), np.asarray(jx), atol=2e-5)


def _quad_host32(center):
    c32 = np.asarray(center, np.float32)
    return lambda x: float(np.sum((np.asarray(x, np.float32) - c32) ** 2))


@pytest.mark.parametrize("iters", [[12, 5, 0], [9, 9, 9]])
def test_batched_nm_matches_nm_run_decision_for_decision(iters):
    """The port's batched NM against the port's own ``nm_run``."""
    x0 = np.full((3, DIM), 0.5, np.float32)
    simplex, fvals, n_evals, branches = batched_nm.batched_nm(
        _tf, torch.from_numpy(x0), iters, 12)
    xb, fb = batched_nm.best_point(simplex, fvals)
    for c in range(3):
        trace = []
        fn = _quad_host32(CENTERS[c])
        st = gradfree.nm_init(fn, x0[c])
        st = gradfree.nm_run(fn, st, iters[c], trace=trace)
        taken = [int(b) for b in branches[c]
                 if b != batched_nm.BRANCH_INACTIVE]
        assert taken == trace                      # decision-for-decision
        assert int(n_evals[c]) == st.n_evals       # eval-for-eval
        np.testing.assert_allclose(xb[c].numpy(), st.best_x, atol=1e-5)
        np.testing.assert_allclose(float(fb[c]), st.best_f, atol=1e-5)
        if iters[c] == 0:
            np.testing.assert_array_equal(
                simplex[c].numpy(),
                batched_nm.init_simplexes(torch.from_numpy(x0))[c].numpy())
