"""The port's batched Nelder–Mead and round engine against the JAX
package's, on identical numpy inputs.

Branch decisions and eval counts must be exactly equal (the NM ladder
quantises float32 noise); simplexes, fvals and trained θ agree within
1e-5 — float32 arithmetic-order noise, the tolerance the JAX package's
own engine-parity tests use.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.batched_engine import BatchedRoundEngine as JaxEngine
from repro.data.tasks import build_task as jax_build_task
from repro.optim import batched_nm as jax_nm
from repro.quantum import backends as jax_backends
from repro.quantum import qnn as jax_qnn
from repro.quantum import tape as jax_tape
from repro_torch import convert
from repro_torch.core.batched_engine import BatchedRoundEngine
from repro_torch.data.tasks import build_task
from repro_torch.optim import batched_nm
from repro_torch.quantum import backends, qnn, tape

# small shapes: one intra-op thread per test worker, or the workers
# oversubscribe the cores
torch.set_num_threads(1)

TOL = 1e-5
TASK = dict(n_clients=3, train_size=90, test_size=45, val_size=30, seed=5)


def _assert_same_vertices(ts, tfv, js, jfv):
    """Each client's simplex equal as a set of (vertex, f) pairs: rows
    whose fvals tie within float32 noise may sit in either order."""
    for c in range(ts.shape[0]):
        free = list(range(js.shape[1]))
        for r in range(ts.shape[1]):
            match = [j for j in free
                     if np.abs(ts[c, r] - js[c, j]).max() <= TOL
                     and abs(tfv[c, r] - jfv[c, j]) <= TOL]
            assert match, f"client {c}: vertex {r} has no JAX counterpart"
            free.remove(match[0])


def _run_both(jf, tf, x0, iters, max_iter, *, row_order=True):
    js, jfv, jev, jbr = jax_nm.batched_nm(jf, jnp.asarray(x0),
                                          jnp.asarray(iters), max_iter)
    ts, tfv, tev, tbr = batched_nm.batched_nm(tf, torch.from_numpy(x0),
                                              iters, max_iter)
    np.testing.assert_array_equal(tbr.numpy(), np.asarray(jbr))
    np.testing.assert_array_equal(tev.numpy(), np.asarray(jev))
    if row_order:
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=TOL,
                                   rtol=0)
        np.testing.assert_allclose(tfv.numpy(), np.asarray(jfv), atol=TOL,
                                   rtol=0)
    else:
        _assert_same_vertices(ts.numpy(), tfv.numpy(), np.asarray(js),
                              np.asarray(jfv))
    jx, jfb = jax_nm.best_point(js, jfv)
    tx, tfb = batched_nm.best_point(ts, tfv)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=TOL, rtol=0)
    np.testing.assert_allclose(tfb.numpy(), np.asarray(jfb), atol=TOL,
                               rtol=0)
    return tbr.numpy()


def test_init_simplexes_match():
    x0 = np.array([[0.0, 1.5, -2.0], [0.25, 0.0, 3.0]], np.float32)
    np.testing.assert_array_equal(
        batched_nm.init_simplexes(torch.from_numpy(x0)).numpy(),
        np.asarray(jax_nm.init_simplexes(jnp.asarray(x0))))


@pytest.mark.parametrize("dim", [2, 6])
def test_quadratic_branches_and_evals_equal(dim):
    C = 4
    centers = (np.linspace(-1, 1, dim)[None, :]
               * (np.arange(C) + 1)[:, None]).astype(np.float32)
    jc, tc = jnp.asarray(centers), torch.from_numpy(centers)
    jf = lambda xs: jnp.sum((xs - jc) ** 2, axis=-1)            # noqa: E731
    tf = lambda xs: torch.sum((xs - tc[:, None]) ** 2, dim=-1)  # noqa: E731
    x0 = np.full((C, dim), 0.5, np.float32)
    branches = _run_both(jf, tf, x0, np.array([7, 3, 0, 12], np.int32), 12)
    # the sweep visits more than one branch kind, and budgets mask
    assert len(set(branches[branches >= 0].tolist())) > 1
    assert (branches[2] == batched_nm.BRANCH_INACTIVE).all()


@pytest.mark.parametrize("kind,n_qubits,name", [("vqc", 4, "genomic"),
                                                ("qcnn", 4, "tweets")])
def test_tape_objective_branches_and_evals_equal(kind, n_qubits, name):
    task = jax_build_task(name, **TASK)
    n_classes = task.n_classes
    B = min(cl.n for cl in task.clients)
    X = np.stack([cl.qX[:B] for cl in task.clients])
    y = np.stack([cl.qy[:B] for cl in task.clients]).astype(np.int32)
    jcq = jax_tape.compile_qnn(jax_qnn.QNNSpec(kind, n_qubits, n_classes))
    spec = qnn.QNNSpec(kind, n_qubits, n_classes)
    cq = tape.compile_qnn(spec)
    jX, jy = jnp.asarray(X), jnp.asarray(y)
    tX, ty = torch.from_numpy(X), torch.from_numpy(y).long()

    def jf(xs):                                               # (C, P)
        probs = jax.vmap(lambda th, Xc: jax_tape.tape_probs(jcq, th, Xc))(
            xs, jX)
        p = jnp.take_along_axis(probs, jy[..., None], -1)[..., 0]
        return -jnp.mean(jnp.log(p + 1e-9), -1)

    def tf(xs):                                               # (C, K, P)
        probs = tape.tape_probs(cq, xs, tX[:, None])
        idx = ty[:, None, :, None].expand(*probs.shape[:-1], 1)
        p = torch.gather(probs, -1, idx)[..., 0]
        return -torch.mean(torch.log(p + 1e-9), -1)

    rng = np.random.default_rng(0)
    x0 = np.tile(rng.uniform(-np.pi, np.pi, spec.n_params), (3, 1))
    # the QCNN's readout ignores some parameters, so its simplexes hold
    # vertices whose fvals tie up to float32 noise: compare them as sets
    _run_both(jf, tf, x0.astype(np.float32),
              np.array([6, 2, 4], np.int32), 8, row_order=kind == "vqc")


@pytest.mark.parametrize("use_llm", [False, True])
def test_run_round_matches_jax_engine(use_llm):
    """One engine round, port vs JAX, with the teacher stacks carried
    across (``convert.from_jax``) for the full F_i + λ·KL + µ·prox."""
    jtask, task = jax_build_task("genomic", **TASK), build_task("genomic",
                                                                **TASK)
    rng = np.random.default_rng(11)
    teachers = [rng.dirichlet(np.ones(2), cl.n).astype(np.float32)
                for cl in jtask.clients] if use_llm else None
    kw = dict(lam=0.1, mu=0.01, use_llm=use_llm, max_iter=10)
    jeng = JaxEngine(jtask, jax_qnn.QNNSpec("vqc"), jax_backends.EXACT,
                     teacher_probs=teachers, optimizer="nelder-mead", **kw)
    teng = BatchedRoundEngine(task, qnn.QNNSpec("vqc"), backends.EXACT,
                              teacher_probs=convert.from_jax(teachers),
                              device="cpu", **kw)
    assert teng.init_evals == jeng.init_evals
    theta_g = rng.uniform(-np.pi, np.pi, 16)
    for maxiters in ([5, 3, 7], [0, 10, 1]):
        jx, jev = jeng.run_round(theta_g, maxiters, 1)
        tx, tev = teng.run_round(convert.from_jax(theta_g), maxiters)
        assert tx.dtype == np.float64 and tev.dtype == np.int64
        np.testing.assert_array_equal(tev, jev)
        np.testing.assert_allclose(tx, jx, atol=TOL, rtol=0)


def test_from_jax_keeps_structure_and_values():
    tree = {"theta": np.arange(3.0), "stacks": [np.ones((2, 2), np.float32),
                                                None]}
    out = convert.from_jax(tree, "cpu")
    assert out["theta"].dtype == torch.float64
    assert out["stacks"][1] is None
    np.testing.assert_array_equal(out["stacks"][0].numpy(), tree["stacks"][0])


def _quadratic(C=4, dim=3):
    centers = (np.linspace(-1, 1, dim)[None, :]
               * (np.arange(C) + 1)[:, None]).astype(np.float32)
    jc, tc = jnp.asarray(centers), torch.from_numpy(centers)
    jf = lambda xs: jnp.sum((xs - jc) ** 2, axis=-1)            # noqa: E731
    tf = lambda xs: torch.sum((xs - tc[:, None]) ** 2, dim=-1)  # noqa: E731
    return jf, tf, np.full((C, dim), 0.5, np.float32)


def test_active_mask_matches_jax():
    """``active=``: an inactive client spends nothing, init included, and
    keeps the init simplex and an all-inactive branch row, as the JAX
    package's ``batched_nm(active=...)``."""
    jf, tf, x0 = _quadratic()
    iters = np.array([7, 3, 5, 12], np.int32)
    active = np.array([True, False, True, False])
    js, jfv, jev, jbr = jax_nm.batched_nm(jf, jnp.asarray(x0),
                                          jnp.asarray(iters), 12,
                                          active=jnp.asarray(active))
    ts, tfv, tev, tbr = batched_nm.batched_nm(
        tf, torch.from_numpy(x0), iters, 12, active=torch.from_numpy(active))
    np.testing.assert_array_equal(tev.numpy(), np.asarray(jev))
    np.testing.assert_array_equal(tbr.numpy(), np.asarray(jbr))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=TOL, rtol=0)
    assert (tev.numpy()[~active] == 0).all()
    assert (tbr.numpy()[~active] == batched_nm.BRANCH_INACTIVE).all()
    np.testing.assert_array_equal(
        ts.numpy()[~active],
        batched_nm.init_simplexes(torch.from_numpy(x0)).numpy()[~active])


@pytest.mark.parametrize("n_steps", [12, 20])
def test_static_trip_count_is_bitwise_the_host_read(n_steps):
    """A static trip count at or above every budget (the fused loop's
    ``max_iter``) gives the bits of the host-read ``max(iters)`` loop."""
    _, tf, x0 = _quadratic()
    iters = np.array([7, 3, 0, 12], np.int32)
    want = batched_nm.batched_nm(tf, torch.from_numpy(x0), iters, 20)
    got = batched_nm.batched_nm(tf, torch.from_numpy(x0), iters, 20,
                                n_steps=n_steps)
    for w, g in zip(want, got):
        assert torch.equal(w, g)
    with pytest.raises(ValueError, match="n_steps"):
        batched_nm.batched_nm(tf, torch.from_numpy(x0), iters, 20,
                              n_steps=21)
