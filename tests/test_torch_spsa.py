"""SPSA in the port's batched engine (``engine="batched",
optimizer="spsa"``) against the JAX package's batched SPSA and against
the port's own sequential engine.

The batched SPSA runs every client's perturbation pairs and candidates
as ``(C, 2, P)`` and ``(C, 1, P)`` stacks through the compiled tape,
with the host-drawn Rademacher signs of ``make_deltas``.  Held to the
JAX package's batched run and to the port's sequential run with the
engine-parity tolerances of ``tests/test_batched_engine.py``: server
loss 1e-4, θ_g 1e-4 (1e-3 for LLM-QFL), budgets, cumulative evals and
selected sets exactly equal.
"""
import numpy as np
import pytest
import torch

from repro.core.orchestrator import Orchestrator as JaxOrchestrator
from repro.core.orchestrator import RunConfig as JaxRunConfig
from repro.data.tasks import build_task as jax_build_task
from repro_torch.core.orchestrator import LLMOutputs, run_experiment
from repro_torch.data.tasks import build_task

torch.set_num_threads(1)

TASKS = {
    "genomic": ("genomic", dict(n_clients=3, train_size=90, test_size=45,
                                val_size=30, seed=5)),
    "tweets": ("tweets", dict(n_clients=3, train_size=60, test_size=24,
                              val_size=24, seed=7)),
}
QFL = dict(method="qfl", optimizer="spsa", n_rounds=3, maxiter0=5,
           early_stop=False)
LLM = dict(method="llm-qfl", optimizer="spsa", n_rounds=3, maxiter0=5,
           llm_steps=4, early_stop=False, seed=2)


def assert_close_runs(got, want, theta_tol):
    for attr in ("t", "maxiters", "cum_evals", "selected"):
        assert got.series(attr) == want.series(attr), attr
    np.testing.assert_allclose(got.series("server_loss"),
                               want.series("server_loss"), atol=1e-4,
                               rtol=0)
    np.testing.assert_allclose(got.series("comm_time_s"),
                               want.series("comm_time_s"), rtol=1e-9)
    np.testing.assert_allclose(got.theta_g, want.theta_g, atol=theta_tol,
                               rtol=0)


@pytest.mark.parametrize("task_name,n_rounds,maxiter0",
                         [("genomic", 3, 5), ("tweets", 2, 4)])
def test_qfl_batched_spsa_matches_jax_and_sequential(task_name, n_rounds,
                                                     maxiter0):
    name, tkw = TASKS[task_name]
    kw = dict(QFL, n_rounds=n_rounds, maxiter0=maxiter0)
    bat = run_experiment(build_task(name, **tkw), device="cpu",
                         engine="batched", **kw)
    want = JaxOrchestrator(jax_build_task(name, **tkw),
                           JaxRunConfig(engine="batched", **kw)).run()
    assert_close_runs(bat, want, 1e-4)
    seq = run_experiment(build_task(name, **tkw), device="cpu",
                         engine="sequential", **kw)
    assert_close_runs(bat, seq, 1e-4)


def test_llm_qfl_batched_spsa_matches_jax_and_sequential():
    """Full Alg. 1 with SPSA, Step 1 carried from the JAX run."""
    name, tkw = TASKS["genomic"]
    orch = JaxOrchestrator(jax_build_task(name, **tkw),
                           JaxRunConfig(engine="batched", **LLM))
    want = orch.run()
    step1 = LLMOutputs(want.llm_losses, want.llm_f1,
                       [np.asarray(t) for t in orch._teacher_probs])
    bat = run_experiment(build_task(name, **tkw), device="cpu",
                         engine="batched", llm_outputs=step1, **LLM)
    assert any(m != 5 for r in bat.rounds[1:] for m in r.maxiters)
    assert_close_runs(bat, want, 1e-3)
    seq = run_experiment(build_task(name, **tkw), device="cpu",
                         engine="sequential", llm_outputs=step1, **LLM)
    assert_close_runs(bat, seq, 1e-3)


def test_batched_engine_spsa_init_evals_and_deltas():
    """SPSA's engine: init_evals 1 (spsa_init's one evaluation), float32
    deltas on the device drawn from the clients' seeds."""
    from repro_torch.core.batched_engine import BatchedRoundEngine
    from repro_torch.optim.batched_spsa import make_deltas
    from repro_torch.quantum import backends, qnn
    name, tkw = TASKS["genomic"]
    task = build_task(name, **tkw)
    spec = qnn.QNNSpec("vqc")
    eng = BatchedRoundEngine(task, spec, backends.get("exact"), lam=0.1,
                             mu=0.01, use_llm=False, seeds=[3, 4, 5],
                             max_iter=6, optimizer="spsa", device="cpu")
    assert eng.init_evals == 1
    assert eng._deltas.dtype == torch.float32
    np.testing.assert_array_equal(eng._deltas.numpy(),
                                  make_deltas([3, 4, 5], 6, spec.n_params))
    nm = BatchedRoundEngine(task, spec, backends.get("exact"), lam=0.1,
                            mu=0.01, use_llm=False, max_iter=6,
                            optimizer="nelder-mead", device="cpu")
    assert nm.init_evals == spec.n_params + 1 and nm._deltas is None
    x, n = eng.run_round(np.zeros(spec.n_params), [2, 0, 1])
    assert n.tolist() == [8, 2, 5]
    np.testing.assert_array_equal(x[1], 0.0)


def _spsa_quadratic(C=4, dim=3, M=8):
    from repro.optim.batched_spsa import make_deltas
    centers = (np.linspace(-1, 1, dim)[None, :]
               * (np.arange(C) + 1)[:, None]).astype(np.float32)
    deltas = make_deltas([11 + c for c in range(C)], M, dim).astype(
        np.float32)
    tc = torch.from_numpy(centers)
    tf = lambda xs: torch.sum((xs - tc[:, None]) ** 2, dim=-1)  # noqa: E731
    return centers, deltas, tf, np.full((C, dim), 0.5, np.float32)


def test_batched_spsa_active_mask_matches_jax():
    """``active=``: an inactive client keeps its start and spends 0
    evaluations, as the JAX package's ``batched_spsa(active=...)``."""
    import jax.numpy as jnp
    from repro.optim.batched_spsa import batched_spsa as jax_spsa
    from repro_torch.optim.batched_spsa import batched_spsa
    centers, deltas, tf, x0 = _spsa_quadratic()
    jc = jnp.asarray(centers)
    iters = np.array([6, 2, 8, 4], np.int32)
    active = np.array([True, False, True, False])
    jx, jfv, jn = jax_spsa(lambda xs: jnp.sum((xs - jc) ** 2, -1),
                           jnp.asarray(x0), jnp.asarray(iters),
                           jnp.asarray(deltas), active=jnp.asarray(active))
    tx, tfv, tn = batched_spsa(tf, torch.from_numpy(x0), iters,
                               torch.from_numpy(deltas),
                               active=torch.from_numpy(active))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    assert (tn.numpy()[~active] == 0).all()
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=1e-5,
                               rtol=0)
    np.testing.assert_array_equal(tx.numpy()[~active], x0[~active])


@pytest.mark.parametrize("n_steps", [8, 6])
def test_batched_spsa_static_trip_count_is_bitwise(n_steps):
    """A static trip count from ``max(iters)`` up to the deltas' depth
    gives the bits of the host-read loop."""
    from repro_torch.optim.batched_spsa import batched_spsa
    _, deltas, tf, x0 = _spsa_quadratic()
    iters = np.array([6, 2, 0, 4], np.int32)
    want = batched_spsa(tf, torch.from_numpy(x0), iters,
                        torch.from_numpy(deltas))
    got = batched_spsa(tf, torch.from_numpy(x0), iters,
                       torch.from_numpy(deltas), n_steps=n_steps)
    for w, g in zip(want, got):
        assert torch.equal(w, g)
    with pytest.raises(ValueError, match="n_steps"):
        batched_spsa(tf, torch.from_numpy(x0), iters,
                     torch.from_numpy(deltas), n_steps=9)
