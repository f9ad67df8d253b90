"""The port's sequential engine against the JAX package's on the
3-class tweets task (the QCNN through parity interpret), and its early
stop; the tolerances of ``test_torch_sequential.py``.
"""
import pytest
import torch

from test_torch_sequential import TOLS, _both, assert_runs_match

torch.set_num_threads(1)


@pytest.mark.parametrize("optimizer", ["nelder-mead", "spsa"])
def test_qcnn_tweets_sequential_matches_jax(optimizer):
    """The 3-class tweets task runs the QCNN through parity interpret."""
    got, want = _both("tweets", method="qfl", optimizer=optimizer,
                      n_rounds=2, maxiter0=4, early_stop=False)
    assert_runs_match(got, want, *TOLS[optimizer])


def test_sequential_early_stop_matches_jax():
    got, want = _both("genomic", method="qfl", n_rounds=6, maxiter0=4,
                      early_stop=True, epsilon=0.05)
    assert len(got.rounds) == len(want.rounds) < 6
    assert got.terminated_early and want.terminated_early
    assert got.series("cum_evals") == want.series("cum_evals")
