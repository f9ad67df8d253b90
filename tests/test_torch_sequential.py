"""The port's sequential engine (``engine="sequential"``, the default)
against the JAX package's, QFL with Nelder–Mead and with SPSA.

``run_experiment(engine="sequential", device="cpu")`` trains one client
at a time with the host optimizers of ``optim/gradfree.py`` on the eager
circuit.  Held to the JAX package's sequential run on the same task:
integer accounting (budgets, cumulative evals, selected sets, rounds)
exactly equal; server and client losses within 1e-5 and θ_g within 1e-4
for Nelder–Mead, 1e-4 and 1e-4 for SPSA — the JAX package's own
engine-parity tolerances (``tests/test_batched_engine.py``).
"""
import numpy as np
import pytest
import torch

from repro.core.orchestrator import run_experiment as jax_run_experiment
from repro.data.tasks import build_task as jax_build_task
from repro_torch.core.orchestrator import run_experiment
from repro_torch.data.tasks import build_task

torch.set_num_threads(1)

TASKS = {
    "genomic": ("genomic", dict(n_clients=3, train_size=90, test_size=45,
                                val_size=30, seed=5)),
    "tweets": ("tweets", dict(n_clients=3, train_size=60, test_size=24,
                              val_size=24, seed=7)),
}
# (server/client loss, θ_g) tolerances of tests/test_batched_engine.py
TOLS = {"nelder-mead": (1e-5, 1e-4), "spsa": (1e-4, 1e-4)}


def _both(task_name, **kw):
    name, tkw = TASKS[task_name]
    got = run_experiment(build_task(name, **tkw), device="cpu",
                         engine="sequential", **kw)
    want = jax_run_experiment(jax_build_task(name, **tkw),
                              engine="sequential", **kw)
    return got, want


def assert_runs_match(got, want, loss_tol, theta_tol):
    assert len(got.rounds) == len(want.rounds)
    for attr in ("t", "maxiters", "cum_evals", "selected"):
        assert got.series(attr) == want.series(attr), attr
    np.testing.assert_allclose(got.series("server_loss"),
                               want.series("server_loss"), atol=loss_tol,
                               rtol=0)
    np.testing.assert_allclose(got.series("client_losses"),
                               want.series("client_losses"), atol=loss_tol,
                               rtol=0)
    np.testing.assert_allclose(got.series("comm_time_s"),
                               want.series("comm_time_s"), rtol=1e-9)
    np.testing.assert_allclose(got.theta_g, want.theta_g, atol=theta_tol,
                               rtol=0)
    assert got.theta_g.dtype == np.float64
    assert got.terminated_early == want.terminated_early


@pytest.mark.parametrize("optimizer", ["nelder-mead", "spsa"])
def test_qfl_sequential_matches_jax(optimizer):
    got, want = _both("genomic", method="qfl", optimizer=optimizer,
                      n_rounds=3, maxiter0=5, early_stop=False)
    assert len(got.rounds) == 3
    assert_runs_match(got, want, *TOLS[optimizer])
    np.testing.assert_allclose(got.series("server_val_acc"),
                               want.series("server_val_acc"), atol=1e-6)
