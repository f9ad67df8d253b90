"""The port's fused round loop (``rounds="fused"``) on the CPU, against
the JAX package's host loop and the port's host loop.

On the CPU the fused round body runs eagerly, a round a call: the code
that the card captures as a CUDA graph.  It is held, at the tolerances
of the JAX package's ``tests/test_fused_rounds.py``, to the **port's
host loop** (``rounds="host"``) and to the **JAX package's host loop**
on that file's five ``_pair`` configurations: selected sets, budgets,
cumulative evaluations and the termination round exactly; client and
server losses within 1e-5; θ_g bitwise the port's host loop's (float64
FedAvg; the JAX package's own fused loop aggregates in float32 and
misses its host loop on the seed-3 Nelder–Mead configuration), and
within 2e-6 of the JAX host loop's but on the two Nelder–Mead
configurations, where the two packages' host loops themselves differ by
2.6226e-6 and 3.0994e-6 and are held to twice that (``JAX_THETA_ATOL``).

Population mode and the twins of the host steps are in
``tests/test_torch_fused_population.py``.
"""
import functools

import numpy as np
import pytest
import torch

from repro.core.orchestrator import Orchestrator as JaxOrchestrator
from repro.core.orchestrator import RunConfig as JaxRunConfig
from repro.data.tasks import build_task as jax_build_task
from repro_torch.core.orchestrator import LLMOutputs, run_experiment
from repro_torch.data.tasks import build_task

# small shapes: one intra-op thread per test worker, or the workers
# oversubscribe the cores
torch.set_num_threads(1)

PAIR_TASK = dict(n_clients=3, train_size=90, test_size=45, val_size=30,
                 seed=5)
# the five _pair configurations of tests/test_fused_rounds.py
PAIRS = {
    "qfl-spsa": dict(method="qfl", optimizer="spsa", n_rounds=6,
                     maxiter0=3, early_stop=False, seed=3),
    "qfl-spsa-shots": dict(method="qfl", optimizer="spsa", n_rounds=6,
                           maxiter0=3, early_stop=False, backend="fake",
                           seed=3),
    "qfl-nm": dict(method="qfl", optimizer="nelder-mead", n_rounds=6,
                   maxiter0=3, early_stop=False, seed=3),
    "llm-qfl-nm-shots": dict(method="llm-qfl", optimizer="nelder-mead",
                             backend="fake", n_rounds=6, maxiter0=3,
                             maxiter_cap=12, select_frac=0.5, llm_steps=4,
                             early_stop=False, seed=3),
    "early-termination": dict(method="qfl", optimizer="spsa", n_rounds=6,
                              maxiter0=3, epsilon=10.0, early_stop=True,
                              seed=3),
}


@functools.lru_cache(maxsize=None)
def _tasks():
    return (jax_build_task("genomic", **PAIR_TASK),
            build_task("genomic", **PAIR_TASK))


@functools.lru_cache(maxsize=None)
def _jax_host(name):
    """The JAX package's host-loop run and its Step 1 outputs."""
    kw = PAIRS[name]
    orch = JaxOrchestrator(_tasks()[0],
                           JaxRunConfig(engine="batched", rounds="host", **kw))
    res = orch.run()
    llm = None
    if kw["method"] == "llm-qfl":
        llm = LLMOutputs(res.llm_losses, res.llm_f1,
                         [np.asarray(t) for t in orch._teacher_probs])
    return res, llm


def _assert_round_parity(host, fused, atol=1e-5, theta_atol=2e-6):
    """``tests/test_fused_rounds.py::_assert_round_parity``."""
    assert len(fused.rounds) == len(host.rounds)
    assert fused.terminated_early == host.terminated_early
    assert fused.series("selected") == host.series("selected")
    assert fused.series("maxiters") == host.series("maxiters")
    assert fused.series("cum_evals") == host.series("cum_evals")
    for fr, hr in zip(fused.rounds, host.rounds):
        np.testing.assert_allclose(fr.client_losses, hr.client_losses,
                                   atol=atol)
        np.testing.assert_allclose(fr.ratios, hr.ratios, rtol=1e-5)
        assert abs(fr.server_loss - hr.server_loss) <= atol
        assert abs(fr.server_val_acc - hr.server_val_acc) <= atol
        assert abs(fr.server_test_acc - hr.server_test_acc) <= atol
        np.testing.assert_allclose(fr.comm_time_s, hr.comm_time_s,
                                   rtol=1e-5, atol=1e-12)
    np.testing.assert_allclose(fused.theta_g, host.theta_g, atol=theta_atol)


# Against the JAX host loop three pairs are held to 2e-6 in θ_g.  The
# two Nelder-Mead runs end 2.6226e-6 (QFL) and 3.0994e-6 (LLM-QFL) from
# it, with the tape's sines and cosines now XLA's own (xla_trig) and with
# its gate products fused as XLA fuses them alike
# (tools/xla_transcendentals.py): the float32 rounding of |psi|^2 and of
# the parity readout carries through six rounds of branch decisions.
# They are held to twice those gaps.
JAX_THETA_ATOL = {"qfl-nm": 5.3e-6, "llm-qfl-nm-shots": 6.2e-6}


@pytest.mark.parametrize("name", list(PAIRS))
def test_fused_matches_both_host_loops(name):
    """Fused == the port's host loop and == the JAX host loop, round for
    round; LLM-QFL on the JAX run's Step 1 outputs."""
    want, llm = _jax_host(name)
    task = _tasks()[1]
    kw = dict(PAIRS[name], engine="batched", device="cpu", llm_outputs=llm)
    host = run_experiment(task, rounds="host", **kw)
    fused = run_experiment(task, rounds="fused", **kw)
    assert len(fused.rounds) == (2 if name == "early-termination" else 6)
    _assert_round_parity(host, fused)
    _assert_round_parity(want, fused,
                         theta_atol=JAX_THETA_ATOL.get(name, 2e-6))
    # on the CPU the fused round is the host loop's arithmetic, bit for bit
    np.testing.assert_array_equal(fused.theta_g, host.theta_g)
    assert fused.series("client_losses") == host.series("client_losses")
    assert fused.theta_g.dtype == np.float64
    if name == "llm-qfl-nm-shots":
        # regulation boosted budgets above maxiter0, and selection kept
        # k = round(0.5 * 3) = 2 clients every round
        assert fused.rounds[-1].maxiters != [3, 3, 3]
        assert all(len(r.selected) == 2 for r in fused.rounds)
    if name == "early-termination":
        assert fused.terminated_early


@pytest.mark.parametrize("name", ["qfl-nm", "qfl-spsa-shots"])
def test_sharded_fused_equals_the_sharded_host_loop(name):
    """The clients axis: over 4 CPU shards (3 clients, 1 inert) the
    fused run is the sharded host loop bit for bit and the one-shard
    fused run, and holds to the JAX host loop as the one-shard run
    does."""
    want, llm = _jax_host(name)
    task = _tasks()[1]
    kw = dict(PAIRS[name], engine="batched", device="cpu", llm_outputs=llm)
    host = run_experiment(task, rounds="host", n_devices=4, **kw)
    fused = run_experiment(task, rounds="fused", n_devices=4, **kw)
    one = run_experiment(task, rounds="fused", **kw)
    for other in (host, one):
        for attr in ("maxiters", "cum_evals", "selected", "server_loss",
                     "client_losses", "ratios", "comm_time_s"):
            assert fused.series(attr) == other.series(attr), attr
        np.testing.assert_array_equal(fused.theta_g, other.theta_g)
    _assert_round_parity(want, fused,
                         theta_atol=JAX_THETA_ATOL.get(name, 2e-6))
