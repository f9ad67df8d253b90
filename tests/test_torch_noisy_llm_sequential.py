"""Full Algorithm 1 on a finite-shot backend, sequential engine, against
the JAX package's (see ``tests/torch_noisy.py``): the keyed distillation
objective samples F_i only, and the regulated budgets match."""
import torch
from torch_noisy import assert_runs_match, run_pair, tasks

torch.set_num_threads(1)


def test_sequential_noisy_llm_qfl_matches_jax():
    got, want, m = run_pair("llm-fake", "sequential", *tasks())
    assert_runs_match(got, want, m, "sequential llm-fake")
