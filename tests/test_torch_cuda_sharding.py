"""The clients axis on the card: two shards against one, bit for bit.
This file imports no JAX, so it runs on a machine with a card and no
JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_sharding.py

Without a card every case skips; the "cards" cases need two cards.  The
"shared" cases put both shards on one card (``share_devices=True``).
Each sharded run equals its one-shard run: the QFL host loop, the fused
loop (whose captured replay runs with no host synchronisation, equals
its op-by-op round and repeats bit for bit) and the LLM stage (held to
one device padded to the same client count).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import random as jr
from repro_torch.core import fused_rounds, llm_client as llmc
from repro_torch.core import run_experiment
from repro_torch.core.batched_llm import BatchedLLMEngine
from repro_torch.data.tasks import build_task
from repro_torch.models import model as M
from repro_torch.quantum import backends, qnn

pytestmark = pytest.mark.cuda

TASK = dict(n_clients=5, train_size=100, test_size=40, val_size=40, seed=2)
RUN = dict(method="qfl", engine="batched", n_rounds=3, maxiter0=4,
           early_stop=False)


@pytest.fixture(params=["shared", "cards"])
def shards(request):
    """``run_experiment`` keywords of two shards on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    if request.param == "cards" and torch.cuda.device_count() < 2:
        pytest.skip("needs two cards")
    torch.backends.cuda.matmul.allow_tf32 = False
    return dict(n_devices=2, share_devices=request.param == "shared")


def _same_runs(a, b):
    for attr in ("maxiters", "cum_evals", "selected", "server_loss",
                 "client_losses", "server_val_acc", "server_test_acc",
                 "ratios"):
        assert a.series(attr) == b.series(attr), attr
    np.testing.assert_array_equal(a.theta_g, b.theta_g)


def _bitwise(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        assert x.dtype == y.dtype and x.shape == y.shape, f.name
        assert np.array_equal(x, y, equal_nan=x.dtype.kind == "f"), f.name


@pytest.mark.parametrize("opts", [dict(optimizer="nelder-mead"),
                                  dict(optimizer="spsa", backend="fake")])
def test_host_loop_two_shards_equal_one(shards, opts):
    task = build_task("genomic", **TASK)
    one = run_experiment(task, **RUN, **opts)
    two = run_experiment(task, **RUN, **opts, **shards)
    _same_runs(one, two)


@pytest.mark.parametrize("opts", [
    dict(optimizer="nelder-mead"),
    dict(optimizer="spsa", backend="fake", c_round=4, dropout=0.25)])
def test_fused_two_shards_graph_is_eager_and_one_shard(shards, opts):
    """A sharded fused run: no sync before its read-back, its replay
    repeats, equals its round op by op, the one-shard fused run and
    (full participation) the sharded host loop."""
    task = build_task("genomic", **TASK)
    spec = qnn.QNNSpec("vqc", n_qubits=4, n_classes=task.n_classes)
    kw = dict(opts)
    backend = backends.get(kw.pop("backend", "exact"))
    theta0 = spec.init_params(jr.split(jr.PRNGKey(1))[1]).numpy()
    fused_rounds._FUSED_CACHE.clear()
    drivers = [fused_rounds.FusedRoundDriver(
        task, spec, backend, seed=1, maxiter0=4, n_rounds=3,
        early_stop=False, **kw, **extra)
        for extra in ({}, shards)]
    outs = []
    for driver in drivers:
        torch.cuda.set_sync_debug_mode("error")
        try:
            driver.start(theta0)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        outs.append(driver.finish())
    one, two = outs
    _bitwise(one, two)
    _bitwise(two, drivers[1].run(theta0))
    drivers[1].start(theta0, graph=False)
    _bitwise(two, drivers[1].finish())
    if "c_round" not in opts:
        host = run_experiment(task, seed=1, **dict(RUN, maxiter0=4),
                              **shards)
        np.testing.assert_array_equal(two.theta_g, host.theta_g)
        assert two.cum_evals.tolist() == host.series("cum_evals")


def test_llm_stage_two_shards_equal_one_device_padded(shards):
    task = build_task("genomic", n_clients=3, train_size=61, test_size=16,
                      val_size=16, seed=3)
    cfg = llmc.task_llm_config("tiny-llm", task.vocab_size,
                               task.llm_seq_len)
    base = M.init_params(cfg, jr.PRNGKey(0), dtype=torch.float32,
                         device="cuda")
    kw = dict(seed=11, steps=3)
    two = BatchedLLMEngine(task, cfg, base, n_devices=2,
                           share_devices=shards["share_devices"], **kw)
    pad = BatchedLLMEngine(task, cfg, base, pad_to=4, **kw)
    a, b = two.run(), pad.run()
    for f in dataclasses.fields(a):
        np.testing.assert_array_equal(getattr(a, f.name),
                                      getattr(b, f.name), err_msg=f.name)
