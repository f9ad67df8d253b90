"""The fused round loop on the card: the captured CUDA graph against the
same round body run op by op, bit for bit.  This file imports no JAX,
so it runs on a machine with a card and no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_fused.py

Without a card every case skips.  Each run replays one round's graph R
times with no host synchronisation (``set_sync_debug_mode("error")``
from the first launch to the copy of the results); the graph holds one
``statevector_tape`` node a tape replay; replaying twice gives the same
bits; and the card's fused run matches its host loop and the CPU's
fused run on every integer.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import random as jr
from repro_torch.core import fused_rounds, run_experiment
from repro_torch.data.tasks import build_task
from repro_torch.quantum import backends, qnn

pytestmark = pytest.mark.cuda

TASK = dict(n_clients=4, train_size=80, test_size=32, val_size=32, seed=2)
CASES = {
    "nm-exact": dict(optimizer="nelder-mead", backend="exact"),
    "spsa-fake-population": dict(optimizer="spsa", backend="fake",
                                 c_round=3, dropout=0.25),
    "nm-aersim-llm": dict(optimizer="nelder-mead", backend="aersim",
                          use_llm=True, maxiter_cap=12, select_frac=0.5),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _driver(name, device):
    kw = dict(CASES[name])
    task = build_task("genomic", **TASK)
    spec = qnn.QNNSpec("vqc", n_qubits=4, n_classes=task.n_classes)
    if kw.get("use_llm"):
        rng = np.random.default_rng(5)
        kw.update(teacher_probs=[rng.dirichlet(np.ones(2), cl.n)
                                 .astype(np.float32) for cl in task.clients],
                  llm_losses=[0.3, 0.45, 0.2, 0.6])
    backend = backends.get(kw.pop("backend"))
    theta0 = spec.init_params(jr.split(jr.PRNGKey(1))[1]).numpy()
    driver = fused_rounds.FusedRoundDriver(
        task, spec, backend, seed=1, maxiter0=3, n_rounds=4,
        early_stop=False, device=device, **kw)
    return driver, theta0


def _bitwise(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        assert x.dtype == y.dtype, f.name
        assert np.array_equal(x, y, equal_nan=x.dtype.kind == "f"), f.name


def _strict_run(driver, theta0, graph=True):
    torch.cuda.set_sync_debug_mode("error")
    try:
        driver.start(theta0, graph=graph)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return driver.finish()


@pytest.mark.parametrize("name", list(CASES))
def test_graph_is_the_eager_round_bitwise(cuda, name):
    fused_rounds._FUSED_CACHE.clear()
    driver, theta0 = _driver(name, cuda)
    graph = _strict_run(driver, theta0)
    assert driver.program.replays == driver.n_rounds
    eager = _strict_run(driver, theta0, graph=False)
    _bitwise(graph, eager)
    _bitwise(graph, _strict_run(driver, theta0))
    gc = driver.program.graph_counts
    assert gc["statevector_tape"] == gc["replays"] > 0
    assert gc["statevector_gate"] == 0


@pytest.mark.parametrize("name", list(CASES))
def test_card_matches_cpu_and_host_reference(cuda, name):
    driver, theta0 = _driver(name, cuda)
    got = driver.run(theta0)
    cpu = _driver(name, "cpu")[0].run(theta0)
    ref = driver.run_host_reference(theta0)
    for want in (cpu, ref):
        for f in ("active", "stop", "cohort", "dropped", "selected",
                  "n_evals", "budgets", "cum_evals"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                          err_msg=f)
        np.testing.assert_allclose(got.losses, want.losses, atol=1e-5)
        np.testing.assert_allclose(got.server_loss, want.server_loss,
                                   atol=1e-5)
        np.testing.assert_allclose(got.theta_g, want.theta_g, atol=2e-6)


def test_run_experiment_fused_matches_host_on_the_card(cuda):
    task = build_task("genomic", **TASK)
    kw = dict(method="qfl", optimizer="nelder-mead", engine="batched",
              n_rounds=4, maxiter0=4, early_stop=False, seed=3)
    host = run_experiment(task, rounds="host", **kw)
    fused = run_experiment(task, rounds="fused", **kw)
    for attr in ("maxiters", "selected", "cum_evals"):
        assert fused.series(attr) == host.series(attr), attr
    np.testing.assert_allclose(fused.series("client_losses"),
                               host.series("client_losses"), atol=1e-5)
    np.testing.assert_allclose(fused.theta_g, host.theta_g, atol=2e-6)
