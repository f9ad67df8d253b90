"""The sequential engine and SPSA on the card: ``LLMClient`` (one client
a launch) against ``BatchedLLMEngine`` (every client a launch) on one
base, and the batched and sequential SPSA and Nelder–Mead runs against
the same runs on the CPU.  This file imports no JAX, so it runs on a
machine with a card and no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_sequential.py

Without a card every case skips.  Tolerances: the batched-LLM ones of the
JAX package's tests (L_LLM and teacher 5e-4, F1 0.05) for Step 1; for
the rounds the engine-parity ones of ``tests/test_batched_engine.py``
(integer accounting exactly; server loss 1e-5 for Nelder–Mead, 1e-4 for
SPSA; θ_g 1e-4).
"""
import numpy as np
import pytest
import torch

from repro_torch import random as jr
from repro_torch.core import llm_client as llmc
from repro_torch.core.batched_llm import BatchedLLMEngine
from repro_torch.core.orchestrator import run_experiment
from repro_torch.data.tasks import build_task
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import lora_matmul as lm
from repro_torch.kernels import statevector_gates as svg
from repro_torch.kernels import statevector_tape as svt
from repro_torch.models import model as M
from repro_torch.optim import batched_spsa
from repro_torch.quantum import tape

pytestmark = pytest.mark.cuda

TASK = dict(n_clients=3, train_size=61, test_size=16, val_size=16, seed=3)
QTASK = dict(n_clients=3, train_size=90, test_size=45, val_size=30, seed=5)
STEPS = 4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _launches():
    return (lm.lora_matmul.launches, fa.flash_attention.launches,
            fa.flash_attention_bwd.launches)


def test_llm_client_matches_batched_engine_on_the_card(cuda):
    task = build_task("genomic", **TASK)
    cfg = llmc.task_llm_config("tiny-llm", task.vocab_size,
                               task.llm_seq_len)
    base = M.init_params(cfg, jr.PRNGKey(0), dtype=torch.float32,
                         device=cuda)
    before = _launches()
    clients, losses, f1s, teachers = llmc.run_sequential_stage(
        task, cfg, base, seed=11, steps=STEPS)
    n = [b - a for a, b in zip(before, _launches())]
    C, L = task.n_clients, cfg.n_layers
    assert n == [C * (STEPS * (10 * L - 2) + 15 * L),
                 C * (STEPS * L + 3 * L), C * STEPS * L], n
    out = BatchedLLMEngine(task, cfg, base, seed=11, steps=STEPS).run()
    np.testing.assert_allclose(losses, out.losses, atol=5e-4)
    np.testing.assert_allclose(f1s, out.f1, atol=0.05)
    for i, t in enumerate(teachers):
        assert t.is_cuda
        np.testing.assert_allclose(t.cpu().numpy(),
                                   out.teacher[i, :task.clients[i].n],
                                   atol=5e-4)
    assert all(cl.device.type == "cuda" for cl in clients)


def test_llm_client_on_the_card_matches_the_cpu(cuda):
    task = build_task("genomic", **TASK)
    cfg = llmc.task_llm_config("tiny-llm", task.vocab_size,
                               task.llm_seq_len)
    stages = []
    for dev in (cuda, "cpu"):
        base = M.init_params(cfg, jr.PRNGKey(0), dtype=torch.float32,
                             device=dev)
        stages.append(llmc.run_sequential_stage(task, cfg, base, seed=11,
                                                steps=STEPS))
    (_, lg, fg, tg), (_, lc, fc, tc) = stages
    np.testing.assert_allclose(lg, lc, atol=5e-4)
    np.testing.assert_allclose(fg, fc, atol=0.05)
    for a, b in zip(tg, tc):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), atol=5e-4)


def _assert_runs_match(gpu, cpu, loss_tol, theta_tol=1e-4):
    for attr in ("maxiters", "selected", "cum_evals"):
        assert gpu.series(attr) == cpu.series(attr), attr
    np.testing.assert_allclose(gpu.series("server_loss"),
                               cpu.series("server_loss"), atol=loss_tol,
                               rtol=0)
    np.testing.assert_allclose(gpu.theta_g, cpu.theta_g, atol=theta_tol,
                               rtol=0)


@pytest.mark.parametrize("task_name", ["genomic", "tweets"])
def test_batched_spsa_on_the_card_matches_the_cpu(cuda, task_name):
    tkw = QTASK if task_name == "genomic" else dict(
        n_clients=3, train_size=60, test_size=24, val_size=24, seed=7)
    kw = dict(method="qfl", optimizer="spsa", engine="batched", n_rounds=3,
              maxiter0=5, early_stop=False)
    svt.statevector_tape.launches = svg.statevector_gate.launches = 0
    tape.run_tape.replays = 0
    gpu = run_experiment(build_task(task_name, **tkw), device=cuda, **kw)
    # one statevector_tape launch a replay; the local phase replays once
    # an evaluation call (start, final, 2 an iteration), each report and
    # server evaluation once more
    assert svt.statevector_tape.launches == tape.run_tape.replays > 36
    assert svg.statevector_gate.launches == 0
    cpu = run_experiment(build_task(task_name, **tkw), device="cpu", **kw)
    _assert_runs_match(gpu, cpu, 1e-4)


@pytest.mark.parametrize("optimizer", ["nelder-mead", "spsa"])
def test_sequential_qfl_on_the_card_matches_the_cpu(cuda, optimizer):
    kw = dict(method="qfl", optimizer=optimizer, engine="sequential",
              n_rounds=2, maxiter0=4, early_stop=False)
    svt.statevector_tape.launches = 0
    gpu = run_experiment(build_task("genomic", **QTASK), device=cuda, **kw)
    assert svt.statevector_tape.launches == 0      # the eager circuit
    cpu = run_experiment(build_task("genomic", **QTASK), device="cpu", **kw)
    _assert_runs_match(gpu, cpu, 1e-5 if optimizer == "nelder-mead"
                       else 1e-4)


def test_batched_spsa_unit_on_the_card_matches_the_cpu(cuda):
    centers = torch.linspace(-1, 1, 6)[None] * torch.arange(1, 4)[:, None]
    deltas = torch.from_numpy(batched_spsa.make_deltas([1, 2, 3], 8, 6))
    out = []
    for dev in (cuda, "cpu"):
        c = centers.to(dev)
        out.append(batched_spsa.batched_spsa(
            lambda xs: torch.sum((xs - c[:, None]) ** 2, -1),
            torch.full((3, 6), 0.5, device=dev), [7, 3, 0], deltas.to(dev)))
    (xg, fg, ng), (xc, fc, nc) = out
    assert ng.cpu().tolist() == nc.tolist() == [23, 11, 2]
    np.testing.assert_allclose(xg.cpu().numpy(), xc.numpy(), atol=2e-5)
    np.testing.assert_allclose(fg.cpu().numpy(), fc.numpy(), atol=2e-5)
