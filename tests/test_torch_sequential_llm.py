"""The port's sequential LLM-QFL (Step 1 one client at a time, then the
regulated, selected quantum rounds on the host optimizers) against the
JAX package's sequential run, with Nelder–Mead and with SPSA.

Step 1, each package drawing its own base and adapters, is held to the
batched-LLM tolerances (L_LLM 5e-4, F1 0.05).  The quantum rounds are
compared with the JAX run's Step 1 outputs installed (``llm_outputs``),
since a 1e-6 difference in the teacher can flip a Nelder–Mead
comparison: integer accounting exactly, server loss within 1e-5 (NM) or
1e-4 (SPSA), θ_g within 1e-4 (NM) or 1e-3 (SPSA), the tolerances of
``tests/test_batched_engine.py``.
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

TASK = ("genomic", dict(n_clients=3, train_size=90, test_size=45,
                        val_size=30, seed=5))
KW = dict(method="llm-qfl", engine="sequential", n_rounds=3, maxiter0=5,
          llm_steps=4, early_stop=False, seed=2)
TOLS = {"nelder-mead": (1e-5, 1e-4), "spsa": (1e-4, 1e-3)}


OPTIMIZER = "nelder-mead"


def jax_run(optimizer):
    name, tkw = TASK
    orch = JaxOrchestrator(jax_build_task(name, **tkw),
                           JaxRunConfig(optimizer=optimizer, **KW))
    res = orch.run()
    return res, [np.asarray(t) for t in orch._teacher_probs]


@pytest.fixture(scope="module")
def jax_runs():
    return {OPTIMIZER: jax_run(OPTIMIZER)}


def check_rounds_match_jax(jax_runs, optimizer):
    want, teachers = jax_runs[optimizer]
    name, tkw = TASK
    got = run_experiment(
        build_task(name, **tkw), device="cpu", optimizer=optimizer,
        llm_outputs=LLMOutputs(want.llm_losses, want.llm_f1, teachers),
        **KW)
    loss_tol, theta_tol = TOLS[optimizer]
    for attr in ("t", "maxiters", "cum_evals", "selected"):
        assert got.series(attr) == want.series(attr), attr
    assert any(m != 5 for r in got.rounds[1:] for m in r.maxiters)
    np.testing.assert_allclose(got.series("ratios"), want.series("ratios"),
                               rtol=1e-5)
    np.testing.assert_allclose(got.series("server_loss"),
                               want.series("server_loss"), atol=loss_tol,
                               rtol=0)
    np.testing.assert_allclose(got.series("client_losses"),
                               want.series("client_losses"), atol=loss_tol,
                               rtol=0)
    np.testing.assert_allclose(got.theta_g, want.theta_g, atol=theta_tol,
                               rtol=0)


def test_llm_qfl_sequential_rounds_match_jax(jax_runs):
    check_rounds_match_jax(jax_runs, OPTIMIZER)


def test_llm_qfl_sequential_step1_matches_jax(jax_runs):
    """The port's own sequential Step 1 against JAX's (one round)."""
    want, teachers = jax_runs[OPTIMIZER]
    name, tkw = TASK
    from repro_torch.core.orchestrator import Orchestrator, RunConfig
    orch = Orchestrator(build_task(name, **tkw),
                        RunConfig(**dict(KW, n_rounds=1)), device="cpu")
    got = orch.run()
    assert len(orch.llm_clients) == 3
    np.testing.assert_allclose(got.llm_losses, want.llm_losses, atol=5e-4)
    np.testing.assert_allclose(got.llm_f1, want.llm_f1, atol=0.05)
    for t, jt in zip(orch.llm_outputs.teacher_probs, teachers):
        np.testing.assert_allclose(t, jt, atol=5e-4)
    assert got.llm_finetune_time_s > 0
    assert got.series("maxiters")[0] == want.series("maxiters")[0]
