"""The whole port: ``run_experiment`` (QFL and LLM-QFL, batched
Nelder–Mead, host rounds) against the JAX package's on the same task.

Integer accounting — budgets, cumulative evals, selected sets, rounds —
must be exactly equal; server and client losses agree within 1e-5 and
θ_g within 1e-4, the JAX package's own engine-parity tolerances.  The
port is held to the JAX **host** round loop.  For LLM-QFL, Step 1 (drawn
by each package from its own keys) is held to the batched-LLM
tolerances (losses 5e-4, F1 0.05); the quantum rounds are compared with
the JAX run's Step 1 outputs installed, since a 1e-6 difference in the
teacher can flip a Nelder–Mead comparison.
"""
import numpy as np
import pytest
import torch

from repro.core.orchestrator import Orchestrator as JaxOrchestrator
from repro.core.orchestrator import RunConfig as JaxRunConfig
from repro.core.orchestrator import run_experiment as jax_run_experiment
from repro.data.tasks import build_task as jax_build_task
from repro_torch.core import orchestrator
from repro_torch.core.orchestrator import (LLMOutputs, RunConfig,
                                           run_experiment)
from repro_torch.data.tasks import build_task

# small shapes: one intra-op thread per test worker, or the workers
# oversubscribe the cores
torch.set_num_threads(1)

KW = dict(method="qfl", optimizer="nelder-mead", engine="batched",
          n_rounds=3, maxiter0=5, early_stop=False)
TASKS = {
    "genomic": ("genomic", dict(n_clients=3, train_size=90, test_size=45,
                                val_size=30, seed=5)),
    "tweets": ("tweets", dict(n_clients=3, train_size=60, test_size=24,
                              val_size=24, seed=7)),
}


@pytest.mark.parametrize("task_name", ["genomic", "tweets"])
def test_run_experiment_matches_jax(task_name):
    name, tkw = TASKS[task_name]
    got = run_experiment(build_task(name, **tkw), device="cpu", **KW)
    want = jax_run_experiment(jax_build_task(name, **tkw), **KW)
    assert len(got.rounds) == len(want.rounds) == 3
    for attr in ("t", "maxiters", "cum_evals", "selected", "ratios"):
        assert got.series(attr) == want.series(attr), attr
    np.testing.assert_allclose(got.series("server_loss"),
                               want.series("server_loss"), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(got.series("client_losses"),
                               want.series("client_losses"), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(got.series("comm_time_s"),
                               want.series("comm_time_s"), atol=1e-12)
    np.testing.assert_allclose(got.theta_g, want.theta_g, atol=1e-4, rtol=0)
    assert got.theta_g.dtype == np.float64
    assert got.terminated_early == want.terminated_early


def test_early_stop_matches_jax():
    name, tkw = TASKS["genomic"]
    kw = dict(KW, n_rounds=6, early_stop=True, epsilon=0.05)
    got = run_experiment(build_task(name, **tkw), device="cpu", **kw)
    want = jax_run_experiment(jax_build_task(name, **tkw), **kw)
    assert len(got.rounds) == len(want.rounds) < 6
    assert got.terminated_early and want.terminated_early
    assert got.series("cum_evals") == want.series("cum_evals")


def test_run_config_defaults_and_fields_match():
    from repro.core.orchestrator import RunConfig as JaxRunConfig
    assert RunConfig() == RunConfig(**vars(JaxRunConfig()))


@pytest.mark.parametrize("override,exc,item", [
    (dict(engine="sequential", rounds="fused"), ValueError,
     "rounds='fused'.*engine='batched'"),
    (dict(engine="sequential", n_devices=2), ValueError,
     "n_devices > 1.*engine='batched'"),
])
def test_unported_options_raise(override, exc, item):
    """Invalid option combinations raise the JAX package's own
    ``ValueError``, in its order."""
    name, tkw = TASKS["genomic"]
    task = build_task(name, **tkw)
    kw = dict(KW, **override)
    with pytest.raises(exc, match=item):
        orchestrator.Orchestrator(task, RunConfig(**kw), device="cpu")
    if exc is ValueError:
        with pytest.raises(exc, match=item):
            JaxOrchestrator(jax_build_task(name, **tkw), JaxRunConfig(**kw))


def test_no_device_means_cuda(monkeypatch):
    """Entry points run on the card unless asked for the CPU: without a
    card, the default raises instead of falling back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    name, tkw = TASKS["genomic"]
    task = build_task(name, **tkw)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        orchestrator.Orchestrator(task, RunConfig(**KW))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_experiment(task, **KW)
    from repro_torch import random as jr
    from repro_torch.core.llm_client import task_llm_config
    from repro_torch.models import model as M
    cfg = task_llm_config("tiny-llm", task.vocab_size, task.llm_seq_len)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        M.init_params(cfg, jr.PRNGKey(0), dtype=torch.float32)


# --- LLM-QFL: Step 1 and the regulated, selected quantum rounds ---------------
LLM_KW = dict(method="llm-qfl", optimizer="nelder-mead", engine="batched",
              n_rounds=2, maxiter0=4, llm_steps=4, early_stop=False)
LLM_TASK = ("genomic", dict(n_clients=3, train_size=60, test_size=24,
                            val_size=24, seed=1))


@pytest.fixture(scope="module")
def jax_llm_runs():
    """The JAX runs and their Step 1 teacher stacks, per select_frac."""
    name, tkw = LLM_TASK
    out = {}
    for frac in (1.0, 0.5):
        orch = JaxOrchestrator(jax_build_task(name, **tkw),
                               JaxRunConfig(select_frac=frac, **LLM_KW))
        res = orch.run()
        out[frac] = (res, [np.asarray(t) for t in orch._teacher_probs])
    return out


def test_llm_qfl_stage_matches_jax(jax_llm_runs):
    name, tkw = LLM_TASK
    got = run_experiment(build_task(name, **tkw), device="cpu", **LLM_KW)
    want, _ = jax_llm_runs[1.0]
    assert len(got.llm_losses) == len(got.llm_f1) == 3
    np.testing.assert_allclose(got.llm_losses, want.llm_losses, atol=5e-4)
    np.testing.assert_allclose(got.llm_f1, want.llm_f1, atol=0.05)
    assert got.llm_finetune_time_s > 0
    assert len(got.rounds) == 2


@pytest.mark.parametrize("select_frac", [1.0, 0.5])
def test_llm_qfl_rounds_match_jax_with_step1_carried(jax_llm_runs,
                                                     select_frac):
    want, teachers = jax_llm_runs[select_frac]
    name, tkw = LLM_TASK
    got = run_experiment(
        build_task(name, **tkw), device="cpu", select_frac=select_frac,
        llm_outputs=LLMOutputs(want.llm_losses, want.llm_f1, teachers),
        **LLM_KW)
    assert got.llm_losses == want.llm_losses
    for attr in ("t", "maxiters", "cum_evals", "selected"):
        assert got.series(attr) == want.series(attr), attr
    if select_frac < 1.0:
        assert all(len(s) < 3 for s in got.series("selected"))
    assert got.series("maxiters")[1] != [LLM_KW["maxiter0"]] * 3
    np.testing.assert_allclose(got.series("ratios"), want.series("ratios"),
                               rtol=1e-5)
    np.testing.assert_allclose(got.series("server_loss"),
                               want.series("server_loss"), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(got.series("client_losses"),
                               want.series("client_losses"), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(got.theta_g, want.theta_g, atol=1e-4, rtol=0)


# --- the clients axis: every option over 8 CPU shards ------------------------
SHARDED = [dict(method=m, rounds=r, optimizer=o, backend=b)
           for m in ("qfl", "llm-qfl") for r in ("host", "fused")
           for o in ("nelder-mead", "spsa") for b in ("exact", "fake")]
SHARDED.append(dict(method="qfl", rounds="fused", optimizer="spsa",
                    backend="fake", c_round=2, dropout=0.25))


@pytest.mark.parametrize("opts", SHARDED, ids=lambda o: "-".join(
    str(v) for v in o.values()))
def test_every_option_runs_over_eight_shards(jax_llm_runs, opts):
    """``run_experiment(task, engine="batched", n_devices=8,
    device="cpu")`` runs every method, round loop, optimizer and
    backend, and population mode (2 shards, cohorts of 2), bit for bit
    as one shard; LLM-QFL on the JAX run's Step 1 outputs."""
    name, tkw = LLM_TASK
    res, teachers = jax_llm_runs[0.5]
    llm = (LLMOutputs(res.llm_losses, res.llm_f1, teachers)
           if opts["method"] == "llm-qfl" else None)
    kw = dict(opts, engine="batched", n_rounds=2, maxiter0=2,
              maxiter_cap=4, select_frac=0.5, early_stop=False)
    n = 2 if "c_round" in opts else 8
    task = build_task(name, **tkw)
    one = run_experiment(task, device="cpu", llm_outputs=llm, **kw)
    shard = run_experiment(task, device="cpu", llm_outputs=llm,
                           n_devices=n, **kw)
    for attr in ("maxiters", "cum_evals", "selected", "server_loss",
                 "client_losses", "ratios", "comm_time_s"):
        for got, want in zip(shard.series(attr), one.series(attr)):
            # NaN where a population client sat the round out
            np.testing.assert_array_equal(got, want, err_msg=attr)
    assert len(shard.rounds) == len(one.rounds) == 2
    np.testing.assert_array_equal(shard.theta_g, one.theta_g)
