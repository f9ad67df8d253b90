"""The port's fused round loop in population mode (``c_round``,
``dropout``) on the CPU, its twins of the host steps, and its validation.

Population runs are held to the port's ``run_host_reference`` and to the
JAX package's ``run_host_reference`` and ``FusedRoundDriver.run``:
cohorts and dropout coins bitwise JAX's (they are derived by the port's
``random.choice`` and ``uniform``), every integer exactly, losses and
server losses within 1e-5, θ_g within 2e-6, and on ``fake`` with equal
shards the reported losses bitwise the host reference's.  The three
twins of the host steps are held to the port's host modules and to the
JAX package's twins on the same inputs, with hypothesis, as the JAX
tests do.  (``tests/test_torch_fused_rounds.py`` holds full
participation to both packages' host loops.)
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core import fused_rounds as jfused
from repro.data.tasks import build_task as jax_build_task
from repro.quantum import backends as jax_backends
from repro.quantum import qnn as jax_qnn
from repro_torch.core import regulation, selection
from repro_torch.core.fused_rounds import (FusedRoundDriver, regulate_batched,
                                           select_topk_mask,
                                           termination_step)
from repro_torch.core.orchestrator import run_experiment
from repro_torch.core.termination import TerminationCriterion
from repro_torch.data.tasks import build_task
from repro_torch.quantum import backends, qnn

# small shapes: one intra-op thread per test worker, or the workers
# oversubscribe the cores
torch.set_num_threads(1)

PAIR_TASK = dict(n_clients=3, train_size=90, test_size=45, val_size=30,
                 seed=5)
POP_TASK = dict(n_clients=12, train_size=96, test_size=32, val_size=32,
                seed=7)


@functools.lru_cache(maxsize=None)
def _tasks(which):
    kw = PAIR_TASK if which == "pair" else POP_TASK
    return jax_build_task("genomic", **kw), build_task("genomic", **kw)


# ---------------------------------------------------------------------------
# population mode: the fused run against the host references
# ---------------------------------------------------------------------------
def _pop_drivers(backend="exact", dropout=0.0, c_round=4, n_rounds=4):
    jtask, task = _tasks("pop")
    kw = dict(optimizer="spsa", seed=4, maxiter0=3, n_rounds=n_rounds,
              early_stop=False, c_round=c_round, dropout=dropout)
    jspec = jax_qnn.QNNSpec("vqc", n_qubits=4, n_classes=jtask.n_classes)
    spec = qnn.QNNSpec("vqc", n_qubits=4, n_classes=task.n_classes)
    theta0 = np.asarray(jspec.init_params(jax.random.PRNGKey(11)),
                        np.float64)
    return (jfused.FusedRoundDriver(jtask, jspec,
                                    jax_backends.get(backend), **kw),
            FusedRoundDriver(task, spec, backends.get(backend),
                             device="cpu", **kw), theta0)


_EXACT = ("active", "stop", "cohort", "dropped", "selected", "n_evals",
          "budgets", "cum_evals", "budgets_final", "cum_evals_final")


def _assert_population_parity(a, b, atol=1e-5):
    for field in _EXACT:
        np.testing.assert_array_equal(getattr(a, field), getattr(b, field),
                                      err_msg=field)
    np.testing.assert_array_equal(np.isnan(a.losses), np.isnan(b.losses))
    np.testing.assert_allclose(a.losses, b.losses, atol=atol)
    np.testing.assert_allclose(a.server_loss, b.server_loss, atol=atol)
    np.testing.assert_allclose(a.theta_g, b.theta_g, atol=2e-6)


@pytest.mark.parametrize("backend,dropout", [("exact", 0.0),
                                             ("fake", 0.25)])
def test_population_parity(backend, dropout):
    """Keyed cohorts and dropout: the fused run equals the port's host
    reference and the JAX package's host reference and fused run."""
    jdriver, driver, theta0 = _pop_drivers(backend, dropout)
    fused = driver.run(theta0)
    host = driver.run_host_reference(theta0)
    _assert_population_parity(fused, host)
    _assert_population_parity(fused, jdriver.run_host_reference(theta0))
    _assert_population_parity(fused, jdriver.run(theta0))
    assert fused.theta_g.dtype == np.float64
    if backend == "fake":
        # equal shards (96 / 12 = 8 rows), so the batched report draws
        # the same shape as the per-client one: bitwise
        np.testing.assert_array_equal(fused.losses, host.losses)
    if dropout:
        assert fused.dropped.any()


def test_population_inertness_and_determinism():
    """Outside-cohort and dropped clients are untouched: carries held,
    zero spend, NaN report, never selected; a same-seed rerun is
    bitwise the same."""
    _, driver, theta0 = _pop_drivers("fake", 0.25)
    out = driver.run(theta0)
    C, R = driver.c_pop, driver.n_rounds
    sampled = set()
    for r in range(R):
        cohort = out.cohort[r]
        sampled.update(int(c) for c in cohort[~out.dropped[r]])
        outside = np.setdiff1d(np.arange(C), cohort)
        prev_b = out.budgets[r - 1] if r else np.full(C, 3)
        prev_c = out.cum_evals[r - 1] if r else np.zeros(C)
        np.testing.assert_array_equal(out.budgets[r][outside],
                                      prev_b[outside])
        np.testing.assert_array_equal(out.cum_evals[r][outside],
                                      prev_c[outside])
        for p in np.nonzero(out.dropped[r])[0]:
            cid = int(cohort[p])
            assert out.n_evals[r][p] == 0
            assert np.isnan(out.losses[r][p])
            assert not out.selected[r][p]
            assert out.budgets[r][cid] == prev_b[cid]
            assert out.cum_evals[r][cid] == prev_c[cid]
    never = sorted(set(range(C)) - sampled)
    assert never, "population too small to leave an untouched client"
    for cid in never:
        assert out.budgets_final[cid] == 3
        assert out.cum_evals_final[cid] == 0
        assert np.isinf(out.last_losses_final[cid])
    again = driver.run(theta0)
    for field in ("cohort", "dropped", "selected", "losses", "n_evals",
                  "budgets", "cum_evals", "theta", "theta_g", "server_loss",
                  "budgets_final", "last_losses_final", "cum_evals_final"):
        np.testing.assert_array_equal(getattr(out, field),
                                      getattr(again, field), err_msg=field)


def test_population_through_run_experiment():
    """``c_round`` and ``dropout`` through the entry point: the records
    are population-sized, sat-out clients report NaN and carry their
    counts."""
    task = _tasks("pop")[1]
    res = run_experiment(task, engine="batched", rounds="fused",
                         device="cpu", method="qfl", optimizer="spsa",
                         n_rounds=3, maxiter0=3, early_stop=False, seed=4,
                         c_round=4, dropout=0.25)
    assert len(res.rounds) == 3
    for r in res.rounds:
        assert len(r.client_losses) == len(r.cum_evals) == 12
        reported = np.isfinite(r.client_losses)
        assert 0 < reported.sum() <= 4
        assert set(r.selected) == set(np.nonzero(reported)[0].tolist())


# ---------------------------------------------------------------------------
# the twins against the port's host modules and the JAX package's twins
# ---------------------------------------------------------------------------
# binary-fraction grid: |a - b| is exact in float32 and float64 alike
_GRID = [-2.0, -0.75, -0.5, -0.25, 0.0, 0.25, 0.5, 0.75, 1.0, 1.5, 2.0,
         float("inf"), float("-inf"), float("nan")]
_FINITE = [v for v in _GRID if np.isfinite(v)]


@given(st.lists(st.sampled_from(_GRID), min_size=1, max_size=12),
       st.sampled_from(_FINITE),
       st.sampled_from([0.05, 0.25, 0.5, 0.75, 1.0]))
@settings(max_examples=60, deadline=None)
def test_prop_select_topk_mask(losses, s, frac):
    k = max(1, int(round(frac * len(losses))))
    d = selection.distances(losses, s)
    mask = select_topk_mask(torch.from_numpy(d), k).numpy()
    assert sorted(np.nonzero(mask)[0].tolist()) == \
        selection.select_aligned(losses, s, frac)
    np.testing.assert_array_equal(mask,
                                  np.asarray(jfused.select_topk_mask(d, k)))
    assert int(mask.sum()) == min(k, len(losses))


def test_select_topk_mask_ties_and_nonfinite():
    d = torch.tensor([1.0, 0.5, 0.5, np.nan, np.inf, 0.5])
    np.testing.assert_array_equal(select_topk_mask(d, 2).numpy(),
                                  [False, True, True, False, False, False])
    np.testing.assert_array_equal(select_topk_mask(d, 1).numpy(),
                                  [False, True, False, False, False, False])
    assert select_topk_mask(d, 6).all()
    assert int(select_topk_mask(torch.tensor([np.nan, np.inf]), 1).sum()) \
        == 1
    # k as a device scalar, as population mode with dropout passes it
    np.testing.assert_array_equal(
        select_topk_mask(d, torch.tensor(2)).numpy(),
        select_topk_mask(d, 2).numpy())


@given(st.integers(1, 120), st.floats(0.01, 8.0),
       st.sampled_from([0.25, 0.5, 1.0, 2.0, 4.0, 0.0, -1.0,
                        float("inf"), float("nan")]),
       st.sampled_from(regulation.VARIANTS), st.integers(3, 40))
@settings(max_examples=80, deadline=None)
def test_prop_regulate_batched(m, q, llm, variant, cap):
    """float64, as the host's Python floats: equal to ``regulate``; the
    JAX twin computes in float32, so against it a result is held inside
    the bracket of a ±2e-6 nudge of ``q``, as the JAX tests hold it."""
    q = float(np.float32(q))
    host = regulation.regulate(m, q, llm, variant=variant, cap=cap)
    got = int(regulate_batched(m, q, llm, variant=variant, cap=cap))
    lo, hi = (regulation.regulate(m, q * f, llm, variant=variant, cap=cap)
              for f in (1 - 2e-6, 1 + 2e-6))
    if variant == "logarithmic" and lo != hi:
        # torch's and Python's log may differ by an ulp at a knife edge
        assert min(lo, hi) <= got <= max(lo, hi)
    else:
        assert got == host, (m, q, llm, variant, cap)
    jgot = int(jfused.regulate_batched(m, q, llm, variant=variant, cap=cap))
    if lo == hi:
        assert jgot == got
    else:
        assert min(lo, hi) <= jgot <= max(lo, hi)


def test_regulate_batched_guard_ladder():
    assert int(regulate_batched(200, 5.0, 0.0, cap=10)) == 200
    assert int(regulate_batched(200, 5.0, float("nan"), cap=10)) == 200
    assert int(regulate_batched(200, float("nan"), 1.0, cap=10)) == 10
    assert int(regulate_batched(5, 0.5, 1.0, cap=10)) == 5
    np.testing.assert_array_equal(
        regulate_batched(torch.tensor([4, 4, 4]),
                         torch.tensor([8.0, 2.0, 1.0]),
                         torch.tensor([1.0, 1.0, 2.0]), cap=10).numpy(),
        [10, 8, 4])
    with pytest.raises(ValueError, match="variant"):
        regulate_batched(4, 2.0, 1.0, variant="nope")


@given(st.lists(st.sampled_from([0.0, 0.25, 0.5, 0.75, 1.0]),
                min_size=1, max_size=8),
       st.sampled_from([1e-3, 0.3, 0.9]),
       st.integers(1, 2), st.integers(1, 8))
@settings(max_examples=60, deadline=None)
def test_prop_termination_step(seq, eps, patience, t_max):
    crit = TerminationCriterion(epsilon=eps, t_max=t_max, patience=patience)
    prev, small = torch.tensor(float("nan")), torch.tensor(0)
    jprev, jsmall = np.float32(np.nan), np.int32(0)
    for t, loss in enumerate(seq, 1):
        want = crit.update(loss, t)
        stop, small = termination_step(prev, small, loss, t, epsilon=eps,
                                       t_max=t_max, patience=patience)
        jstop, jsmall = jfused.termination_step(
            jprev, jsmall, loss, t, epsilon=eps, t_max=t_max,
            patience=patience)
        prev, jprev = torch.tensor(loss), np.float32(loss)
        assert bool(stop) == want == bool(jstop), (seq, eps, patience, t)
        assert int(small) == int(jsmall)
        if want:
            break


def test_termination_step_tmax_before_patience():
    stop, small = termination_step(1.0, 0, 1.0, 2, epsilon=0.9, t_max=2)
    assert bool(stop) and int(small) == 0
    stop, small = termination_step(1.0, 0, 1.0, 2, epsilon=0.9, t_max=5)
    assert bool(stop) and int(small) == 1
    stop, _ = termination_step(0.0, 0, 0.0, 3, epsilon=1e-3, t_max=9)
    assert bool(stop)
    stop, _ = termination_step(0.5, 0, 0.0, 3, epsilon=1e-3, t_max=9)
    assert not bool(stop)


# ---------------------------------------------------------------------------
# validation
# ---------------------------------------------------------------------------
def test_driver_validation():
    task = _tasks("pair")[1]
    spec = qnn.QNNSpec("vqc", n_qubits=4, n_classes=task.n_classes)
    be = backends.get("exact")
    for kw, match in ((dict(c_round=0), "c_round"),
                      (dict(c_round=4), "c_round"),
                      (dict(dropout=1.0), "dropout"),
                      (dict(use_llm=True), "use_llm"),
                      (dict(optimizer="cobyla"), "optimizer")):
        with pytest.raises(ValueError, match=match):
            FusedRoundDriver(task, spec, be, device="cpu", **kw)
    # the cohort is cut into the shards each round: it must divide them
    with pytest.raises(ValueError, match="does not divide across 2"):
        FusedRoundDriver(task, spec, be, device="cpu", n_devices=2,
                         c_round=1)
    assert FusedRoundDriver(task, spec, be, device="cpu",
                            c_round=3).c_round is None


def test_population_options_need_fused_rounds():
    task = _tasks("pair")[1]
    with pytest.raises(ValueError, match="fused"):
        run_experiment(task, engine="batched", device="cpu", c_round=2)
    with pytest.raises(ValueError, match="batched"):
        run_experiment(task, rounds="fused", engine="sequential",
                       device="cpu")


def test_population_over_eight_shards():
    """The clients axis: C_pop=12, cohorts of 8 cut over 8 CPU shards,
    ``fake``, dropout 0.25: the sharded fused run equals the one-shard
    run bit for bit, and the JAX package's fused run and host
    reference as the one-shard run does."""
    jdriver, driver, theta0 = _pop_drivers("fake", 0.25, c_round=8,
                                           n_rounds=3)
    _, task = _tasks("pop")
    sharded = FusedRoundDriver(
        task, driver.spec, driver.backend, device="cpu", n_devices=8,
        optimizer="spsa", seed=4, maxiter0=3, n_rounds=3, early_stop=False,
        c_round=8, dropout=0.25)
    assert len(sharded.program.shards) == 8
    got, one = sharded.run(theta0), driver.run(theta0)
    for f in dataclasses.fields(one):
        a, b = getattr(one, f.name), getattr(got, f.name)
        assert a.dtype == b.dtype and a.shape == b.shape, f.name
        np.testing.assert_array_equal(a, b, err_msg=f.name)
    assert got.dropped.any()
    _assert_population_parity(got, jdriver.run(theta0))
