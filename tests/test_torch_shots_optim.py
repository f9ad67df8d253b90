"""Keyed optimizers against the JAX package's on one keyed objective.

A quadratic plus a key-dependent offset, ``0.05 · uniform(key)``: any
evaluation drawn under another key than JAX's moves its value, so the
slot schedules (Nelder–Mead: init row ``r`` → ``r``, iteration ``i`` →
``(n+1) + i·(n+3) + arange(n+3)``; SPSA: ``0``, ``1+3k``, ``2+3k``,
``3+3k``, ``FINAL_EVAL_SLOT``) are held slot for slot, and the branch
traces and eval counts exactly.  The sequential ``gradfree`` runs are
float64 numpy in both packages: bitwise.  The batched ones are float32
on the device: x within 2e-5, as ``tests/test_torch_gradfree.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import batched_nm as jax_bnm
from repro.optim import batched_spsa as jax_bspsa
from repro.optim import gradfree as jax_gf
from repro_torch import random as jr
from repro_torch.optim import batched_nm, batched_spsa, gradfree
from repro_torch.quantum.backends import FINAL_EVAL_SLOT

torch.set_num_threads(1)

DIM, C, NOISE = 5, 3, 0.05
CENTERS = np.linspace(-1, 1, DIM)[None, :] * (np.arange(C) + 1.0)[:, None]


def _host_fn(center, draw):
    c = np.asarray(center, np.float64)
    return lambda x, key: float(np.sum((np.asarray(x) - c) ** 2)
                                + NOISE * float(draw(key)))


def _streams(seed=9, client=1):
    base = jr.fold_in(jr.fold_in(jr.PRNGKey(seed), 2), client)
    jbase = jax.random.fold_in(
        jax.random.fold_in(jax.random.PRNGKey(seed), 2), client)
    slots, jslots = [], []

    def ks(slot):
        slots.append(int(slot))
        return jr.fold_in(base, slot)

    def jks(slot):
        jslots.append(int(slot))
        return jax.random.fold_in(jbase, slot)

    return ks, jks, slots, jslots


@pytest.mark.parametrize("chunks", [(9,), (3, 0, 6)])
def test_keyed_nm_run_matches_jax(chunks):
    fn = _host_fn(CENTERS[1], lambda k: jr.uniform(k, ()))
    jfn = _host_fn(CENTERS[1], lambda k: jax.random.uniform(k, ()))
    ks, jks, slots, jslots = _streams()
    x0 = np.array([0.5, -0.3, 0.0, 1.2, -2.0])
    opt = gradfree.GradFreeOptimizer(fn, x0, key_stream=ks)
    jopt = jax_gf.GradFreeOptimizer(jfn, x0, key_stream=jks)
    trace, jtrace = [], []
    for k in chunks:
        opt.state = gradfree.nm_run(fn, opt.state, k, trace=trace,
                                    key_stream=ks)
        jopt.state = jax_gf.nm_run(jfn, jopt.state, k, trace=jtrace,
                                   key_stream=jks)
    assert slots == jslots and trace == jtrace
    assert slots[:DIM + 1] == list(range(DIM + 1))
    assert (opt.n_evals, opt.state.n_iters) == (jopt.n_evals,
                                                jopt.state.n_iters)
    np.testing.assert_array_equal(opt.state.simplex, jopt.state.simplex)
    np.testing.assert_array_equal(opt.state.fvals, jopt.state.fvals)
    opt.set_fn(fn)          # a keyed re-evaluation replays the init slots
    jopt.set_fn(jfn)
    assert slots[-(DIM + 1):] == list(range(DIM + 1)) and slots == jslots
    np.testing.assert_array_equal(opt.state.fvals, jopt.state.fvals)


@pytest.mark.parametrize("chunks", [(8,), (3, 5)])
def test_keyed_spsa_run_matches_jax(chunks):
    fn = _host_fn(CENTERS[0], lambda k: jr.uniform(k, ()))
    jfn = _host_fn(CENTERS[0], lambda k: jax.random.uniform(k, ()))
    ks, jks, slots, jslots = _streams(client=0)
    x0 = np.full(DIM, 0.25)
    st = gradfree.spsa_init(fn, x0, seed=17, key_stream=ks)
    jst = jax_gf.spsa_init(jfn, x0, seed=17, key_stream=jks)
    for k in chunks:
        st = gradfree.spsa_run(fn, st, k, key_stream=ks)
        jst = jax_gf.spsa_run(jfn, jst, k, key_stream=jks)
    assert slots == jslots
    assert slots[:4] == [0, 1, 2, 3] and slots[-1] == FINAL_EVAL_SLOT
    np.testing.assert_array_equal(st.x, jst.x)
    assert (st.f, st.k, st.n_evals) == (jst.f, jst.k, jst.n_evals)


def _ckeys(seed=3, round_idx=2):
    ck = jr.fold_in(jr.fold_in(jr.PRNGKey(seed), round_idx), np.arange(C))
    jck = jax.vmap(jax.random.fold_in, in_axes=(None, 0))(
        jax.random.fold_in(jax.random.PRNGKey(seed), round_idx),
        jnp.arange(C))
    return ck, jck


def _batched_objectives(log):
    """The port's ``f(xs (C, K, P), slots (K,))`` and JAX's ``f(xs (C, P),
    slot)``: quadratic + NOISE · uniform(fold_in(ckey_c, slot))."""
    ck, jck = _ckeys()
    centers = torch.tensor(CENTERS, dtype=torch.float32)
    jcenters = jnp.asarray(CENTERS, jnp.float32)

    def f(xs, slots):
        log.append(np.asarray(slots).tolist())
        keys = jr.fold_in(ck[:, None, :], slots)               # (C, K, 2)
        u = jr.uniform_stack(keys.reshape(-1, 2), ()).reshape(keys.shape[:2])
        return torch.sum((xs - centers[:, None]) ** 2, -1) + NOISE * u

    def jf(xs, slot):
        u = jax.vmap(lambda k: jax.random.uniform(
            jax.random.fold_in(k, slot), ()))(jck)
        return jnp.sum((xs - jcenters) ** 2, -1) + NOISE * u

    return f, jf


@pytest.mark.parametrize("iters", [[12, 5, 0], [9, 9, 9]])
def test_keyed_batched_nm_matches_jax(iters):
    log = []
    f, jf = _batched_objectives(log)
    x0 = np.full((C, DIM), 0.5, np.float32)
    simplex, fvals, n_evals, branches = batched_nm.batched_nm(
        f, torch.from_numpy(x0), iters, 12, keyed=True)
    js, jfv, jn, jb = jax_bnm.batched_nm(jf, jnp.asarray(x0),
                                         jnp.asarray(iters), 12, keyed=True)
    n = DIM
    assert log[0] == list(range(n + 1))
    assert log[1:] == [list((n + 1) + i * (n + 3) + np.arange(n + 3))
                       for i in range(max(iters))]
    np.testing.assert_array_equal(branches.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(n_evals.numpy(), np.asarray(jn))
    xb, fb = batched_nm.best_point(simplex, fvals)
    jxb, jfb = jax_bnm.best_point(js, jfv)
    np.testing.assert_allclose(xb.numpy(), np.asarray(jxb), atol=2e-5)
    np.testing.assert_allclose(fb.numpy(), np.asarray(jfb), atol=2e-5)


def test_keyed_batched_spsa_matches_jax():
    log = []
    f, jf = _batched_objectives(log)
    iters = [7, 3, 0]
    deltas = batched_spsa.make_deltas([101, 202, 303], 8, DIM)
    x0 = np.full((C, DIM), 0.5, np.float32)
    x, f_final, n_evals = batched_spsa.batched_spsa(
        f, torch.from_numpy(x0), iters, torch.from_numpy(deltas), keyed=True)
    jx, jf_final, jn = jax_bspsa.batched_spsa(
        jf, jnp.asarray(x0), jnp.asarray(iters), jnp.asarray(deltas),
        keyed=True)
    want = [[0]] + [s for k in range(7) for s in
                    ([1 + 3 * k, 2 + 3 * k], [3 + 3 * k])] + \
        [[FINAL_EVAL_SLOT]]
    assert log == want
    np.testing.assert_array_equal(n_evals.numpy(), np.asarray(jn))
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), atol=2e-5)
    np.testing.assert_allclose(f_final.numpy(), np.asarray(jf_final),
                               atol=2e-5)
    np.testing.assert_array_equal(x[2].numpy(), x0[2])
