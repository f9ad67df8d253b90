"""Full Algorithm 1 on a finite-shot backend against the JAX package's:
LLM-QFL with regulated Nelder–Mead on ``fake``, batched engine (see
``tests/torch_noisy.py``).  Regulation consumes the sampled losses, so
the integer budgets hold only if every draw agrees."""
import torch
from torch_noisy import assert_runs_match, run_pair, tasks

torch.set_num_threads(1)


def test_batched_noisy_llm_qfl_matches_jax():
    got, want, m = run_pair("llm-fake", "batched", *tasks())
    assert_runs_match(got, want, m, "batched llm-fake")
