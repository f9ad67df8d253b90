"""The port's ``run_experiment(task)`` with every default setting (the
JAX package's defaults: ``method="llm-qfl"``, ``engine="sequential"``,
``optimizer="nelder-mead"``, 10 rounds, 30 Step-1 steps), on the CPU,
against the JAX package's ``run_experiment(task)``.

Each package draws its own base and adapters.  Held to: equal
``maxiters``, ``selected`` and ``cum_evals``; server loss within 1e-5;
θ_g within 1e-4; L_LLM within 5e-4.
"""
import numpy as np
import pytest
import torch

from repro.core import run_experiment as jax_run_experiment
from repro.data.tasks import build_task as jax_build_task
from repro_torch.core import RunConfig, run_experiment
from repro_torch.data.tasks import build_task

torch.set_num_threads(1)

TASK = dict(n_clients=3, train_size=90, test_size=45, val_size=30, seed=5)


@pytest.fixture(scope="module")
def runs():
    got = run_experiment(build_task("genomic", **TASK), device="cpu")
    want = jax_run_experiment(jax_build_task("genomic", **TASK))
    return got, want


def test_defaults_are_sequential_nelder_mead_llm_qfl(runs):
    got, _ = runs
    rc = got.config
    assert rc == RunConfig()
    assert (rc.method, rc.engine, rc.optimizer) == (
        "llm-qfl", "sequential", "nelder-mead")
    assert len(got.llm_losses) == 3 and got.llm_finetune_time_s > 0


def test_default_run_integer_accounting_matches_jax(runs):
    got, want = runs
    assert len(got.rounds) == len(want.rounds)
    for attr in ("t", "maxiters", "selected", "cum_evals"):
        assert got.series(attr) == want.series(attr), attr
    assert got.terminated_early == want.terminated_early


def test_default_run_losses_and_theta_match_jax(runs):
    got, want = runs
    np.testing.assert_allclose(got.llm_losses, want.llm_losses, atol=5e-4)
    np.testing.assert_allclose(got.series("server_loss"),
                               want.series("server_loss"), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(got.series("client_losses"),
                               want.series("client_losses"), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(got.theta_g, want.theta_g, atol=1e-4, rtol=0)
