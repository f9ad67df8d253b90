"""The batched engine on finite-shot backends against the JAX package's
batched engine, on its own noisy parity configurations (QFL; see
``tests/torch_noisy.py`` for what is held and how)."""
import pytest
import torch
from torch_noisy import CONFIGS, assert_runs_match, run_pair, tasks

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def both_tasks():
    return tasks()


@pytest.mark.parametrize("name", [n for n in CONFIGS if n != "llm-fake"])
def test_batched_noisy_run_matches_jax(both_tasks, name):
    got, want, m = run_pair(name, "batched", *both_tasks)
    assert_runs_match(got, want, m, f"batched {name}")
