"""The sequential engine's Nelder–Mead on finite-shot backends against
the JAX package's, on its noisy parity configurations (``fake`` and
``aersim``; see ``tests/torch_noisy.py``)."""
import pytest
import torch
from torch_noisy import assert_runs_match, run_pair, tasks

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def both_tasks():
    return tasks()


@pytest.mark.parametrize("name", ["nm-fake", "nm-aersim", "noise-spsa"])
def test_sequential_noisy_nm_matches_jax(both_tasks, name):
    got, want, m = run_pair(name, "sequential", *both_tasks)
    assert_runs_match(got, want, m, f"sequential {name}")
