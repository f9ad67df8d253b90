"""The port's copies of the paper's control laws — regulation, alignment
selection, termination — held equal to the JAX package's host modules
(property tests on grids with ties, NaN and inf)."""
import math

from hypothesis import given, settings, strategies as st

from repro.core import regulation as jax_regulation
from repro.core import selection as jax_selection
from repro.core import termination as jax_termination
from repro_torch.core import regulation, selection, termination

NAN, INF = float("nan"), float("inf")
# losses with ties, exact halves (round-half-to-even) and non-finite values
LOSS = st.sampled_from([0.0, 0.25, 0.5, 0.5, 0.75, 1.0, 1.25, 1.5, 2.0,
                        3.0, 1e-12, NAN, INF, -INF])
LOSSES = st.lists(LOSS, min_size=1, max_size=12)


def _same(a, b):
    return (a == b) or (isinstance(a, float) and isinstance(b, float)
                        and math.isnan(a) and math.isnan(b))


@settings(max_examples=200, deadline=None)
@given(st.integers(0, 120), LOSS, LOSS,
       st.sampled_from(list(regulation.VARIANTS)), st.integers(1, 100))
def test_regulate_equal(maxiter, qnn_loss, llm_loss, variant, cap):
    got = regulation.regulate(maxiter, qnn_loss, llm_loss, variant=variant,
                              cap=cap)
    want = jax_regulation.regulate(maxiter, qnn_loss, llm_loss,
                                   variant=variant, cap=cap)
    assert got == want and type(got) is type(want)


def test_regulate_rounds_half_to_even():
    # 10 · 1.25 = 12.5 → 12 (to even); 10 · 1.35 = 13.5 → 14
    for q, want in ((1.25, 12), (1.35, 14)):
        assert regulation.regulate(10, q, 1.0) == want
        assert jax_regulation.regulate(10, q, 1.0) == want


@settings(max_examples=200, deadline=None)
@given(LOSSES, LOSS, st.sampled_from([0.1, 0.3, 0.5, 0.75, 1.0]))
def test_select_aligned_equal(losses, server_loss, frac):
    got = selection.select_aligned(losses, server_loss, frac)
    assert got == jax_selection.select_aligned(losses, server_loss, frac)
    assert len(got) >= 1


@settings(max_examples=200, deadline=None)
@given(LOSSES, LOSS, st.integers(0, 11))
def test_selection_variance_equal(losses, server_loss, k):
    sel = list(range(min(k, len(losses)) + 1))[:len(losses)]
    got = selection.selection_variance(losses, server_loss, sel)
    want = jax_selection.selection_variance(losses, server_loss, sel)
    assert got.keys() == want.keys()
    for key in got:
        assert _same(got[key], want[key])


@settings(max_examples=200, deadline=None)
@given(st.lists(LOSS, min_size=1, max_size=10),
       st.sampled_from([1e-3, 0.1, 0.5]), st.integers(1, 8),
       st.integers(1, 3))
def test_termination_equal(history, epsilon, t_max, patience):
    got = termination.TerminationCriterion(epsilon=epsilon, t_max=t_max,
                                           patience=patience)
    want = jax_termination.TerminationCriterion(epsilon=epsilon, t_max=t_max,
                                                patience=patience)
    for t, loss in enumerate(history, start=1):
        assert got.update(loss, t) == want.update(loss, t)
    assert len(got.history) == len(want.history)


def test_termination_zero_loss_plateau():
    for mod in (termination, jax_termination):
        crit = mod.TerminationCriterion(epsilon=1e-3, t_max=10)
        assert not crit.update(0.5, 1)
        assert not crit.update(0.0, 2)      # a fresh drop to 0 is progress
        assert crit.update(0.0, 3)          # a zero-loss plateau converged
